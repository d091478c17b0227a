"""What belongs to one model family, found by the ``family`` a
configuration file names: ``families/<family>.py`` gives ``sizes(cfg)``
(the sizes the drivers and references use), ``specs(s)`` (the parameter
tree in the layout the port's ``LM(cfg, params=...)`` takes, each leaf's
shape, dtype and initial distribution; ``weights.py`` draws it) and
``model_config(cfg)`` (the port's ``ModelConfig``).  Its plain reference
is ``reference/<family>_lm.py``.  A new family is new files."""
