"""Control plane: file-level bundling and adaptive transfer-tuning policies.

``TransferPolicySpec`` declares the policy on a scenario; ``BundleComposer``
bin-packs the catalog into transfer tasks; ``ConcurrencyTuner`` /
``BundleSizeTuner`` steer live concurrency caps and future bundle sizing
from per-route flow telemetry; ``ControlPlane`` wires it all onto one
campaign runtime, checkpointable down to the cursor.
"""
from repro_torch.control.bundles import (BUNDLE_PREFIX, BalancedPacker,
                                   BundleCaps, BundleComposer, BundleItem,
                                   BundlePolicy, GreedyPacker, make_packer)
from repro_torch.control.controllers import (BundleSizeTuner, ConcurrencyTuner,
                                       Controller, make_controllers)
from repro_torch.control.plane import ControlPlane, PolicyLedger
from repro_torch.control.policy import STATIC_POLICY, TransferPolicySpec

__all__ = [
    "BUNDLE_PREFIX", "BalancedPacker", "BundleCaps", "BundleComposer",
    "BundleItem", "BundlePolicy", "BundleSizeTuner", "ConcurrencyTuner",
    "ControlPlane", "Controller", "GreedyPacker", "PolicyLedger",
    "STATIC_POLICY", "TransferPolicySpec", "make_controllers", "make_packer",
]
