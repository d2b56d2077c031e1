"""Deterministic fault injection for crash-safety testing.

:mod:`karpenter_tpu_torch.chaos.inject` holds a seeded
:class:`~karpenter_tpu_torch.chaos.inject.FaultPlan` and the shims for the
boundaries the port's control plane crosses: the kube API server
(:class:`~karpenter_tpu_torch.chaos.inject.ChaosKube`), the fake provider's
create, the pressure monitor's samples and the write-ahead journal's kill
points. Production code only touches it through
:func:`~karpenter_tpu_torch.chaos.inject.active_fault`, one ``None`` check
when no plan is installed. :mod:`karpenter_tpu_torch.chaos.soak` is the
crash-restart scenario that drives every kill point.
"""
