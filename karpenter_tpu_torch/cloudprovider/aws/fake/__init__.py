"""Programmable fake AWS SDK surface (reference: pkg/cloudprovider/aws/fake/)."""

from karpenter_tpu_torch.cloudprovider.aws.fake.ec2api import (  # noqa: F401
    CapacityPool,
    EC2Behavior,
    FakeEC2API,
    default_instance_type_infos,
    default_security_groups,
    default_subnets,
)
from karpenter_tpu_torch.cloudprovider.aws.fake.ssmapi import FakeSSMAPI  # noqa: F401
