from karpenter_tpu_torch.metrics import core  # noqa: F401  (attaches help text)
