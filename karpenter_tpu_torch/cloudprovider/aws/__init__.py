"""The AWS cloud provider (reference: pkg/cloudprovider/aws/).

A copy of the JAX package's plane. Importing this package registers the
"aws" provider in the SPI registry.
"""

from karpenter_tpu_torch.cloudprovider.aws.provider import AWSCloudProvider  # noqa: F401
from karpenter_tpu_torch.cloudprovider.aws.vendor import AWSProvider  # noqa: F401
