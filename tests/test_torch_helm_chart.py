"""The port's chart renderer (karpenter_tpu_torch/utils/helmlite.py) and the
port's chart (charts/karpenter-tpu-torch).

- The port's ``render_chart`` on the JAX package's chart is byte for byte
  the JAX renderer's, with the defaults and with the overrides of
  tests/test_helm_chart.py::test_values_plumb_through.
- The port's values reader (no ``yaml`` import) equals ``yaml.safe_load``
  on both charts' values files and on seeded documents in its subset, and
  raises, naming the line, outside it. PyYAML is imported here only.
- The port's chart: its default render is pinned by a golden file, its
  values plumb through, every flag its controller writes parses with the
  port's options parser and validates, the webhook's with the server's
  parser, and the CRD's printer columns are the JAX chart's.
- chip_smoke.py's reader of a rendered Deployment's container (it boots
  the chart's command lines without PyYAML) equals ``yaml.safe_load``.
"""

import os
import random
import re

import pytest
import yaml

import chip_smoke
from karpenter_tpu.utils import helmlite as jax_helmlite
from karpenter_tpu_torch.config import options
from karpenter_tpu_torch.utils import helmlite
from karpenter_tpu_torch.utils.helmlite import (
    ValuesSyntaxError, parse_values, render_chart,
)
from karpenter_tpu_torch.webhooks import server

REPO = os.path.join(os.path.dirname(__file__), "..")
JAX_CHART = os.path.join(REPO, "charts", "karpenter-tpu")
CHART = os.path.join(REPO, "charts", "karpenter-tpu-torch")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "chart_torch_default.yaml")
CLUSTER = {"clusterName": "prod-1", "clusterEndpoint": "https://api.example:6443"}

# tests/test_helm_chart.py::test_values_plumb_through's overrides
JAX_OVERRIDES = {
    "namespace": "autoscaling",
    "controller.image": "registry.example/karpenter:9.9.9",
    "controller.replicas": 3,
    "controller.ports.metrics": 9090,
    "controller.tpuChips": 4,
    "clusterName": "prod-1",
    "leaderElect": False,
    "webhook.port": 9443,
}


def docs_by_kind_name(rendered):
    return {(d["kind"], d["metadata"]["name"]): d
            for d in yaml.safe_load_all(rendered) if d}


def container(rendered, name):
    return docs_by_kind_name(rendered)[("Deployment", name)]["spec"]["template"]["spec"][
        "containers"][0]


def pod_argv(rendered, name):
    """The argv the kubelet runs for the Deployment ``name``'s container,
    read with yaml.safe_load: ``$(VAR)`` expanded from its env, where an
    entry that reads the pod's namespace gives the Deployment's."""
    doc = docs_by_kind_name(rendered)[("Deployment", name)]
    c = doc["spec"]["template"]["spec"]["containers"][0]
    env = {e["name"]: e["value"] if "value" in e else doc["metadata"]["namespace"]
           for e in c.get("env", [])}
    return chip_smoke.kubelet_argv({"command": c["command"], "args": c.get("args", []),
                                    "env": env})


# -- the renderer against the JAX package's --------------------------------------

@pytest.mark.parametrize("overrides", [None, JAX_OVERRIDES], ids=["defaults", "plumb"])
def test_render_of_the_jax_chart_is_byte_identical(overrides):
    assert render_chart(JAX_CHART, overrides) == jax_helmlite.render_chart(JAX_CHART, overrides)


@pytest.mark.parametrize("chart", [JAX_CHART, CHART], ids=["jax", "port"])
def test_values_reader_equals_safe_load_on_the_charts(chart):
    with open(os.path.join(chart, "values.yaml")) as f:
        text = f.read()
    assert parse_values(text) == yaml.safe_load(text)


def test_render_of_the_port_chart_with_the_jax_renderer_is_identical():
    assert render_chart(CHART) == jax_helmlite.render_chart(CHART)


def test_unknown_values_key_fails_loudly(tmp_path):
    (tmp_path / "templates").mkdir()
    (tmp_path / "values.yaml").write_text("a: 1\n")
    (tmp_path / "templates" / "x.yaml").write_text("v: {{ .Values.missing.key }}\n")
    with pytest.raises(KeyError):
        render_chart(str(tmp_path))


def test_cli_renders_with_set(capsys):
    assert helmlite.main([CHART, "--set", "namespace=ops"]) == 0
    out = capsys.readouterr().out
    assert out == render_chart(CHART, {"namespace": "ops"})
    assert helmlite.main([]) == 2
    assert helmlite.main([CHART, "--bogus"]) == 2


# -- the values reader's subset ----------------------------------------------------

WORDS = ["karpenter", "info", "aws", "in-cluster", "google.com/tpu", "nvidia.com/gpu",
         "registry.example/karpenter:9.9.9", "/var/cache/k", "a_b", "http://x:1/y", "v1+2"]
QUANTITIES = ["100m", "1Gi", "128Mi", "8Gi", "256Mi", "2Ti"]
KEYS = ["namespace", "image", "replicas", "ports", "metrics", "cpu", "memory", "limits",
        "requests", "gpuResource", "log_level", "a.b", "x-y", "_hidden"]


def seeded_document(rng):
    """A values document in the subset: nested block mappings at two or
    four spaces, every kind of scalar, comments of both kinds, blank lines."""
    lines = []

    def scalar():
        kind = rng.randrange(8)
        if kind == 0:
            return str(rng.choice([0, 1, 7, 8080, -3, 65535, 123456789]))
        if kind == 1:
            return rng.choice(["true", "false"])
        if kind == 2:
            return '"' + rng.choice(["", "1", "true", "a b", "x: y", "#z", "8Gi"]) + '"'
        if kind == 3:
            return "'" + rng.choice(["", "0", "no", "k: v", "\"q\""]) + "'"
        if kind == 4:
            return rng.choice(QUANTITIES)
        return rng.choice(WORDS)

    def mapping(indent, depth):
        step = rng.choice([2, 4])
        for key in rng.sample(KEYS, rng.randint(1, 5)):
            if rng.random() < 0.2:
                lines.append(" " * rng.randrange(0, 8) + "# " + rng.choice(WORDS))
            if rng.random() < 0.15:
                lines.append("")
            if depth < 3 and rng.random() < 0.35:
                lines.append(" " * indent + key + ":" + rng.choice(["", "  # nested"]))
                mapping(indent + step, depth + 1)
            else:
                tail = rng.choice(["", "", "  # note", " #x"])
                lines.append(" " * indent + f"{key}: {scalar()}{tail}")

    mapping(0, 0)
    return "\n".join(lines) + rng.choice(["\n", "", "\n\n"])


@pytest.mark.parametrize("seed", range(40))
def test_values_reader_equals_safe_load_on_seeded_documents(seed):
    text = seeded_document(random.Random(seed))
    assert parse_values(text) == yaml.safe_load(text), text


@pytest.mark.parametrize("text,line", [
    ("a: &anchor 1\nb: *anchor\n", 1),                       # an anchor
    ("a: 1\nb: *anchor\n", 2),                               # an alias
    ("a: [1, 2]\n", 1),                                      # a flow list
    ("a: {b: 1}\n", 1),                                      # a flow mapping
    ("a:\n\tb: 1\n", 2),                                     # a tab indent
    ("a:\n  - 1\n  - 2\n", 2),                               # a block sequence
    ("a: |\n  text\n", 1),                                   # a block scalar
    ("a: !!str 1\n", 1),                                     # a tag
    ("a: 1\na: 2\n", 2),                                     # a key twice
    ("a:\nb: 1\n", 1),                                       # a null value
    ("a: yes\n", 1),                                         # a YAML 1.1 bool word
    ("a: 1.5\n", 1),                                         # a float
    ("a: 012\n", 1),                                         # a YAML 1.1 octal
    ("a: 1e3\n", 1),                                         # not an int, not a word
    ("a: hello world\n", 1),                                 # a plain scalar with a space
    ('a: "x\\ny"\n', 1),                                     # an escape
    ("a: 'it''s'\n", 1),                                     # a quote inside quotes
    ('a: "x" y\n', 1),                                       # text after a quoted scalar
    ("  a: 1\n", 1),                                         # an indented top
    ("a:\n  b: 1\n    c: 2\n", 3),                           # an unexpected indent
    ("---\na: 1\n", 1),                                      # a document marker
    ("true: 1\n", 1),                                        # a bool key
    ("a:b\n", 1),                                            # no space after the colon
])
def test_values_reader_refuses_outside_the_subset(text, line):
    with pytest.raises(ValuesSyntaxError, match=rf"values\.yaml:{line}\b"):
        parse_values(text)


def test_values_reader_refuses_an_empty_file():
    with pytest.raises(ValuesSyntaxError):
        parse_values("# only a comment\n\n")


def test_the_port_imports_no_yaml():
    for path in (os.path.join(REPO, "karpenter_tpu_torch", "utils", "helmlite.py"),
                 os.path.join(REPO, "chip_smoke.py")):
        with open(path) as f:
            assert not re.search(r"^\s*(import|from)\s+yaml\b", f.read(), re.M), path


# -- the port's chart ----------------------------------------------------------------

def test_default_render_matches_golden():
    with open(GOLDEN) as f:
        assert render_chart(CHART) == f.read()


def test_chart_files_and_kinds():
    with open(os.path.join(CHART, "Chart.yaml")) as f:
        meta = yaml.safe_load(f)
    assert meta["name"] == "karpenter-tpu-torch" and meta["apiVersion"] == "v2"
    docs = docs_by_kind_name(render_chart(CHART))
    assert {"Namespace", "ServiceAccount", "ConfigMap", "Deployment", "Service",
            "ClusterRole", "ClusterRoleBinding", "MutatingWebhookConfiguration",
            "ValidatingWebhookConfiguration"} <= {k for k, _ in docs}
    # plain substitutions only, so helm template and the renderer agree
    for fname in os.listdir(os.path.join(CHART, "templates")):
        with open(os.path.join(CHART, "templates", fname)) as f:
            text = f.read()
        assert text.count("{{") == len(re.findall(r"\{\{ \.Values\.[A-Za-z0-9_.]+ \}\}", text))


def test_crd_is_the_jax_charts_and_served_as_v1alpha5():
    with open(os.path.join(CHART, "crds", "karpenter.sh_provisioners.yaml")) as f:
        ours = f.read()
    with open(os.path.join(JAX_CHART, "crds", "karpenter.sh_provisioners.yaml")) as f:
        assert ours == f.read()
    crd = yaml.safe_load(ours)
    assert crd["kind"] == "CustomResourceDefinition"
    assert [v["name"] for v in crd["spec"]["versions"]] == ["v1alpha5"]


def test_crd_printer_columns_reference_conditions_the_controller_writes():
    """As tests/test_helm_chart.py holds them: Active and SolverHealthy,
    the counter controller's resources, and Age re-added."""
    with open(os.path.join(CHART, "crds", "karpenter.sh_provisioners.yaml")) as f:
        src = f.read()
    assert "additionalPrinterColumns" in src
    assert set(re.findall(r'@\.type=="(\w+)"', src)) == {"Active", "SolverHealthy"}
    assert ".status.resources.cpu" in src
    assert ".status.resources.memory" in src
    assert ".metadata.creationTimestamp" in src


def test_values_plumb_through():
    rendered = render_chart(CHART, overrides={
        **CLUSTER,
        "namespace": "autoscaling",
        "controller.image": "registry.example/karpenter-torch:1.2.3",
        "controller.replicas": 2,
        "controller.ports.metrics": 9090,
        "controller.gpus": 2,
        "kubeBackend": "memory",
        "leaderElect": False,
        "traceAnnotations": True,
        "webhook.port": 9443,
        "webhook.replicas": 3,
    })
    docs = docs_by_kind_name(rendered)
    ctl = docs[("Deployment", "karpenter-controller")]
    spec = ctl["spec"]["template"]["spec"]["containers"][0]
    assert ctl["metadata"]["namespace"] == "autoscaling" and ctl["spec"]["replicas"] == 2
    assert spec["image"] == "registry.example/karpenter-torch:1.2.3"
    assert spec["command"] == ["python", "-m", "karpenter_tpu_torch.main"]
    for flag in ("--device=cuda", "--kube-backend=memory", "--leader-elect=false",
                 "--trace-annotations=true", "--metrics-port=9090", "--solver-warmup"):
        assert flag in spec["args"], flag
    assert {"name": "CLUSTER_NAME", "value": "prod-1"} in spec["env"]
    assert spec["ports"][0]["containerPort"] == 9090
    for probe in ("startupProbe", "livenessProbe", "readinessProbe"):
        assert spec[probe]["httpGet"]["port"] == 9090
    assert spec["resources"]["limits"]["nvidia.com/gpu"] == 2
    assert spec["resources"]["requests"]["nvidia.com/gpu"] == 2
    assert "google.com/tpu" not in rendered
    # the warm-up's kernel libraries go to an emptyDir volume
    cache = [a for a in spec["args"] if a.startswith("--solver-compile-cache-dir=")]
    assert len(cache) == 1
    mount = spec["volumeMounts"][0]
    assert mount["mountPath"] == cache[0].split("=", 1)[1]
    volumes = ctl["spec"]["template"]["spec"]["volumes"]
    assert volumes[0]["name"] == mount["name"] and "emptyDir" in volumes[0]
    hook = docs[("Deployment", "karpenter-webhook")]
    assert hook["spec"]["replicas"] == 3
    wspec = hook["spec"]["template"]["spec"]["containers"][0]
    assert wspec["command"] == ["python", "-m", "karpenter_tpu_torch.webhooks.server"]
    assert "--port=9443" in wspec["args"] and "--kube-backend=memory" in wspec["args"]
    assert docs[("Service", "karpenter-webhook")]["spec"]["ports"][0]["targetPort"] == 9443
    hooks = docs[("MutatingWebhookConfiguration", "defaulting.webhook.karpenter.sh")]
    assert hooks["webhooks"][0]["clientConfig"]["service"]["namespace"] == "autoscaling"


def test_startup_probe_allows_for_the_warmup():
    """The warm-up runs before the HTTP endpoints come up (8.5-10.1 s to
    /readyz on an H100, a first boot also builds the libraries): the
    startup probe's allowance is minutes, and liveness waits for it."""
    spec = container(render_chart(CHART), "karpenter-controller")
    startup = spec["startupProbe"]
    assert startup["periodSeconds"] * startup["failureThreshold"] >= 120
    assert startup["httpGet"]["path"] == "/healthz"


def test_controller_memory_covers_the_process():
    """The request and the limit are the card's measured process
    (PERF.md): more than the 4.4 GiB that importing torch with CUDA
    takes, where the JAX chart's 1Gi would OOM-kill the controller at
    boot; the webhook imports no torch and keeps its small limit."""
    res = container(render_chart(CHART), "karpenter-controller")["resources"]
    gib = {k: int(v[:-2]) for k, v in
           ((k, res[k]["memory"]) for k in ("requests", "limits"))}
    assert all(v.endswith("Gi") for v in (res["requests"]["memory"], res["limits"]["memory"]))
    assert 5 <= gib["requests"] <= gib["limits"]
    wres = container(render_chart(CHART), "karpenter-webhook")["resources"]
    assert wres["limits"]["memory"] == "256Mi"


@pytest.mark.parametrize("values", [{}, {"leaderElect": False, "traceAnnotations": True,
                                         "cloudProvider": "fake", "kubeBackend": "memory"}])
def test_every_controller_flag_parses_and_validates(values, monkeypatch):
    monkeypatch.delenv("POD_NAMESPACE", raising=False)
    rendered = render_chart(CHART, {**CLUSTER, **values})
    argv = pod_argv(rendered, "karpenter-controller")
    assert argv[:3] == ["python", "-m", "karpenter_tpu_torch.main"]
    opts = options.parse(argv[3:])
    assert opts.validate() == []
    assert opts.cluster_name == "prod-1" and opts.device == "cuda"
    assert opts.solver_warmup is True and opts.solver_compile_cache_dir
    assert opts.leader_elect is values.get("leaderElect", True)
    assert opts.trace_annotations is values.get("traceAnnotations", False)
    assert opts.kube_backend == values.get("kubeBackend", "in-cluster")
    assert opts.cloud_provider == values.get("cloudProvider", "aws")


def test_the_charts_default_has_no_cluster_name():
    argv = pod_argv(render_chart(CHART), "karpenter-controller")
    assert options.parse(argv[3:]).validate()[0] == "cluster-name is required"


def test_every_webhook_flag_parses():
    rendered = render_chart(CHART, {"namespace": "ops", "webhook.port": 9443})
    argv = pod_argv(rendered, "karpenter-webhook")
    assert argv[:3] == ["python", "-m", "karpenter_tpu_torch.webhooks.server"]
    args = server.parse_args(argv[3:])
    assert (args.port, args.namespace, args.kube_backend, args.cloud_provider, args.tls) == \
        (9443, "ops", "in-cluster", "aws", True)


# -- chip_smoke.py's reader of a rendered container, as the kubelet runs it -------------

@pytest.mark.parametrize("chart", [JAX_CHART, CHART], ids=["jax", "port"])
@pytest.mark.parametrize("name", ["karpenter-controller", "karpenter-webhook"])
def test_deployment_container_equals_safe_load(chart, name):
    rendered = render_chart(chart, {**CLUSTER, "namespace": "ops"})
    want = container(rendered, name)
    got = chip_smoke.deployment_container(rendered, name)
    assert got["command"] == want["command"] and got["args"] == want["args"]
    assert got["resources"] == want["resources"]
    assert got["namespace"] == "ops"
    env = {e["name"]: e.get("value") for e in want["env"]}
    for e in want["env"]:
        if "valueFrom" in e:
            assert e["valueFrom"] == {"fieldRef": {"fieldPath": "metadata.namespace"}}
            env[e["name"]] = "ops"
    assert got["env"] == env


def test_kubelet_argv_expands_like_the_kubelet():
    c = {"command": ["run"], "args": ["--a=$(A)", "--b=$(MISSING)", "--c=$$(A)", "$(A)$(A)"],
         "env": {"A": "x"}}
    assert chip_smoke.kubelet_argv(c) == ["run", "--a=x", "--b=$(MISSING)", "--c=$(A)", "xx"]


def test_deployment_container_refuses_what_it_cannot_read():
    with pytest.raises(ValueError):
        chip_smoke.deployment_container(render_chart(CHART), "karpenter-nothing")
