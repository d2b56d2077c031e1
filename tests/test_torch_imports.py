"""The port imports neither JAX nor anything of the JAX package.

Checked in a subprocess, because tests/conftest.py imports jax into the
whole pytest process: there ``sys.modules["jax"] = None`` makes any
``import jax`` raise, every port module (and chip_smoke.py) is imported,
and no ``karpenter_tpu.`` module may have been loaded.
"""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
import karpenter_tpu_torch
names = ["karpenter_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(karpenter_tpu_torch.__path__,
                                          "karpenter_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m == "karpenter_tpu" or m.startswith("karpenter_tpu."))
print(json.dumps({"imported": names, "leaked": leaked}))
"""


def test_port_imports_without_jax_or_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["leaked"] == []
    expected = {"karpenter_tpu_torch.ops.pack_cuda",
                "karpenter_tpu_torch.models.ffd",
                "karpenter_tpu_torch.solver.solve",
                "karpenter_tpu_torch.solver.adapter",
                "karpenter_tpu_torch.solver.batch_solve",
                "karpenter_tpu_torch.ops.device_filter",
                "karpenter_tpu_torch.parallel.batched_pack",
                "karpenter_tpu_torch.ops.global_solve",
                "karpenter_tpu_torch.solver.global_solve",
                "karpenter_tpu_torch.solver.relax",
                "karpenter_tpu_torch.api.provisioner",
                "karpenter_tpu_torch.api.gang",
                "karpenter_tpu_torch.utils.clock",
                "karpenter_tpu_torch.utils.pod",
                "karpenter_tpu_torch.utils.fastcopy",
                "karpenter_tpu_torch.runtime.kubecore",
                "karpenter_tpu_torch.cloudprovider.fake.provider",
                "karpenter_tpu_torch.pressure.bands",
                "karpenter_tpu_torch.pressure.monitor",
                "karpenter_tpu_torch.scheduling.batcher",
                "karpenter_tpu_torch.scheduling.topology",
                "karpenter_tpu_torch.scheduling.scheduler",
                "karpenter_tpu_torch.solver.pipeline",
                "karpenter_tpu_torch.controllers.provisioning",
                "karpenter_tpu_torch.controllers.selection",
                "karpenter_tpu_torch.utils.node",
                "karpenter_tpu_torch.scheduling.affinity",
                "karpenter_tpu_torch.models.consolidate",
                "karpenter_tpu_torch.ops.whatif",
                "karpenter_tpu_torch.ops.whatif_cuda",
                "karpenter_tpu_torch.ops.gang_cuda",
                "karpenter_tpu_torch.ops.type_shard_cuda",
                "karpenter_tpu_torch.solver.whatif",
                "karpenter_tpu_torch.controllers.node",
                "karpenter_tpu_torch.controllers.termination",
                "karpenter_tpu_torch.controllers.consolidation",
                "karpenter_tpu_torch.ops.gang",
                "karpenter_tpu_torch.ops.topology",
                "karpenter_tpu_torch.solver.gang",
                "karpenter_tpu_torch.solver.topology",
                "karpenter_tpu_torch.scheduling.preempt_budget",
                "karpenter_tpu_torch.main",
                "karpenter_tpu_torch.native",
                "karpenter_tpu_torch.solver.native_ffd",
                "karpenter_tpu_torch.solver.warmup",
                "karpenter_tpu_torch.runtime.manager",
                "karpenter_tpu_torch.runtime.leaderelection",
                "karpenter_tpu_torch.config.options",
                "karpenter_tpu_torch.controllers.logging_config",
                "karpenter_tpu_torch.cloudprovider.metrics",
                "karpenter_tpu_torch.utils.workers",
                "karpenter_tpu_torch.utils.gcguard",
                "karpenter_tpu_torch.build_dir",
                "karpenter_tpu_torch.api.codec",
                "karpenter_tpu_torch.api.codec_core",
                "karpenter_tpu_torch.utils.ratelimit",
                "karpenter_tpu_torch.runtime.kubeclient",
                "karpenter_tpu_torch.runtime.stubserver",
                "karpenter_tpu_torch.webhooks",
                "karpenter_tpu_torch.webhooks.admission",
                "karpenter_tpu_torch.webhooks.certs",
                "karpenter_tpu_torch.webhooks.server",
                "karpenter_tpu_torch.utils.cache",
                "karpenter_tpu_torch.cloudprovider.aws",
                "karpenter_tpu_torch.cloudprovider.aws.sdk",
                "karpenter_tpu_torch.cloudprovider.aws.sigv4",
                "karpenter_tpu_torch.cloudprovider.aws.awsclient",
                "karpenter_tpu_torch.cloudprovider.aws.vendor",
                "karpenter_tpu_torch.cloudprovider.aws.discovery",
                "karpenter_tpu_torch.cloudprovider.aws.instancetype",
                "karpenter_tpu_torch.cloudprovider.aws.instancetypes",
                "karpenter_tpu_torch.cloudprovider.aws.launchtemplate",
                "karpenter_tpu_torch.cloudprovider.aws.instance",
                "karpenter_tpu_torch.cloudprovider.aws.provider",
                "karpenter_tpu_torch.cloudprovider.aws.fake",
                "karpenter_tpu_torch.cloudprovider.aws.fake.ec2api",
                "karpenter_tpu_torch.cloudprovider.aws.fake.ssmapi",
                "karpenter_tpu_torch.cloudprovider.aws.fake.stubserver"}
    assert expected <= set(report["imported"])


def test_port_sources_name_no_jax():
    offenders = []
    for path in [*sorted((REPO / "karpenter_tpu_torch").rglob("*.py")),
                 REPO / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1 and (
                    words[1].split(".")[0] in ("jax", "jaxlib", "karpenter_tpu")):
                offenders.append(f"{path.relative_to(REPO)}: {line.strip()}")
    assert offenders == []
