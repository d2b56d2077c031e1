"""The port's process options (config/options.py) against the JAX
package's: the same argv and environment give the same fields, and
validate() the same errors, except for the recorded differences:

- ``--device`` (port only) takes the place of ``JAX_PLATFORMS``;
- ``--trace-annotations`` (port) replaces ``--trace-jax`` (JAX);
- ``--solver-use-device`` (JAX only) is gone;
- ``--cloud-provider aws`` fails the port's validate() as not yet ported;
  ``--kube-backend in-cluster`` validates in both packages.
"""

import dataclasses

import pytest

from karpenter_tpu.config import options as jax_options
from karpenter_tpu_torch.config import options as port_options

JAX_ONLY = {"solver_use_device", "trace_jax"}
PORT_ONLY = {"device", "trace_annotations"}

ARGVS = [
    [],
    ["--cluster-name", "c", "--cluster-endpoint", "http://x"],
    ["--cluster-name", "c", "--cluster-endpoint", "http://x", "--metrics-port", "9090",
     "--leader-elect", "--namespace", "karpenter", "--batch-idle-seconds", "0.25",
     "--batch-max-items", "1000", "--provisioning-shards", "3"],
    ["--pipeline-depth", "1", "--pipeline-chunk-items", "0", "--no-pipeline-adaptive",
     "--no-solver-donate", "--solver-warmup", "--packing-policy", "interruption-priced",
     "--policy-repack-cost", "1.5", "--window-backend", "ffd"],
    ["--gc-interval-seconds", "0", "--gc-grace-seconds", "30", "--no-pressure-enabled",
     "--pressure-max-depth", "500", "--pressure-rss-watermark-mb", "0",
     "--pressure-dwell-seconds", "1", "--pressure-split-items", "64",
     "--pressure-aging-seconds", "5"],
    ["--trace-enabled", "--trace-dump", "/tmp/t.json", "--flight-dir", "/tmp/f",
     "--journal-dir", "/tmp/j", "--no-journal-fsync", "--no-slo-enabled",
     "--slo-objectives", "default=30,high=20:0.995", "--slo-fast-window-seconds", "10",
     "--slo-slow-window-seconds", "100", "--slo-fast-burn", "2", "--slo-slow-burn", "0.5"],
    ["--aws-node-name-convention", "resource-name", "--no-aws-eni-limited-pod-density",
     "--kube-client-qps", "5", "--kube-client-burst", "10", "--webhook-port", "9443",
     "--health-probe-port", "9081", "--solver-compile-cache-dir", "/tmp/cache"],
]


def shared(opts, only):
    return {k: v for k, v in dataclasses.asdict(opts).items() if k not in only}


@pytest.mark.parametrize("argv", ARGVS)
def test_same_argv_same_fields(argv):
    assert shared(port_options.parse(argv), PORT_ONLY) == \
        shared(jax_options.parse(argv), JAX_ONLY)


def test_defaults_equal_and_the_differences():
    port, jax = port_options.Options(), jax_options.Options()
    assert shared(port, PORT_ONLY) == shared(jax, JAX_ONLY)
    assert port.device == "cuda" and port.trace_annotations is jax.trace_jax is False
    assert not hasattr(port, "solver_use_device")
    flags = port_options.parse(["--trace-annotations", "--device", "cpu"])
    assert flags.trace_annotations is True and flags.device == "cpu"


ENVS = [
    {"KARPENTER_CLUSTER_NAME": "env-c", "KARPENTER_METRICS_PORT": "7000",
     "KARPENTER_LEADER_ELECT": "true", "KARPENTER_BATCH_MAX_SECONDS": "2.5"},
    {"KARPENTER_PIPELINE_ADAPTIVE": "0", "KARPENTER_WINDOW_BACKEND": "ffd",
     "KARPENTER_JOURNAL_DIR": "/tmp/jj", "KARPENTER_SLO_FAST_BURN": "3",
     "POD_NAMESPACE": "karpenter"},
]


@pytest.mark.parametrize("env", ENVS)
def test_same_environment_same_fields(env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert shared(port_options.parse([]), PORT_ONLY) == shared(jax_options.parse([]), JAX_ONLY)
    assert shared(port_options.Options(), PORT_ONLY) == shared(jax_options.Options(), JAX_ONLY)


def test_device_from_the_environment(monkeypatch):
    monkeypatch.setenv("KARPENTER_DEVICE", "cpu")
    monkeypatch.setenv("KARPENTER_TRACE_ANNOTATIONS", "yes")
    opts = port_options.parse([])
    assert opts.device == "cpu" and opts.trace_annotations is True


INVALID = [
    {},
    {"cluster_name": "c"},
    {"cluster_name": "c", "cluster_endpoint": "e", "metrics_port": 0},
    {"cluster_name": "c", "cluster_endpoint": "e", "webhook_port": 70000},
    {"cluster_name": "c", "cluster_endpoint": "e", "kube_backend": "etcd"},
    {"cluster_name": "c", "cluster_endpoint": "e", "gc_interval_seconds": -1},
    {"cluster_name": "c", "cluster_endpoint": "e", "pressure_max_depth": 0,
     "pressure_rss_watermark_mb": -1, "pressure_dwell_seconds": -1,
     "pressure_split_items": 0, "pressure_aging_seconds": -1},
    {"cluster_name": "c", "cluster_endpoint": "e", "provisioning_shards": -1,
     "pipeline_depth": 0, "pipeline_chunk_items": -1},
    {"cluster_name": "c", "cluster_endpoint": "e", "slo_fast_window_seconds": 0,
     "slo_fast_burn": 0, "slo_objectives": "default"},
    {"cluster_name": "c", "cluster_endpoint": "e", "slo_objectives": "default=-1"},
    {"cluster_name": "c", "cluster_endpoint": "e", "slo_objectives": "default=30:1.5"},
    {"cluster_name": "c", "cluster_endpoint": "e", "packing_policy": "fastest",
     "policy_repack_cost": -2.0},
    {"cluster_name": "c", "cluster_endpoint": "e", "window_backend": "magic",
     "aws_node_name_convention": "dns"},
    {"cluster_name": "c", "cluster_endpoint": "e"},
]


@pytest.mark.parametrize("fields", INVALID)
def test_validate_gives_the_same_errors(fields):
    assert port_options.Options(**fields).validate() == \
        jax_options.Options(**fields).validate()


@pytest.mark.parametrize("fields,error", [
    # the API client is ported: in-cluster validates, as in the JAX package
    ({"kube_backend": "in-cluster"}, None),
    ({"cloud_provider": "aws"}, "cloud-provider aws: not yet ported"),
    ({"device": "tpu"}, "device invalid: tpu"),
])
def test_port_refuses_what_it_has_not_ported(fields, error):
    errs = port_options.Options(cluster_name="c", cluster_endpoint="e", **fields).validate()
    if error is None:
        assert errs == []
    else:
        assert len(errs) == 1 and errs[0].startswith(error)
    assert jax_options.Options(cluster_name="c", cluster_endpoint="e",
                               **{k: v for k, v in fields.items()
                                  if k != "device"}).validate() == []
