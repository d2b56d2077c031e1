"""The port's AWS wire stack against the JAX package's, on the CPU.

- SigV4 (``cloudprovider/aws/sigv4.py``): AWS's published worked examples,
  and the signed headers, signing keys and canonical queries of seeded
  requests at a fixed clock equal to the JAX package's byte for byte;
  ``flatten_params`` equal on seeded nested structures.
- The clients (``awsclient.Ec2Client`` / ``SsmClient``): the same script of
  EC2 and SSM calls, made once by each package's client against the port's
  stub endpoint (``cloudprovider/aws/fake/stubserver.py``) over a fresh
  fake, gives the same requests, request for request (form, target,
  Authorization, token), and the same parsed answers: the paged catalog,
  offerings, subnets, groups, templates, the fleet with its ICE errors,
  instances by id and by tag, termination and its NotFound.
- Errors: the retryable codes, the EC2 and SSM error parsers, the retry
  schedule (full jitter pinned), a non-retryable error and exhaustion.
- IMDSv2 and the credential chain: region and role credentials from the
  stub's metadata service, the session token cached, env before file
  before IMDS, ``resolve_region`` env first, ``default_clients`` with
  endpoints.

Every comparison is exact.
"""

import dataclasses
import itertools
import json
import random

import pytest

from karpenter_tpu.cloudprovider.aws import awsclient as jax_ac
from karpenter_tpu.cloudprovider.aws import sdk as jax_sdk
from karpenter_tpu.cloudprovider.aws import sigv4 as jax_sigv4
from karpenter_tpu_torch.cloudprovider.aws import awsclient as port_ac
from karpenter_tpu_torch.cloudprovider.aws import sdk as port_sdk
from karpenter_tpu_torch.cloudprovider.aws import sigv4 as port_sigv4
from karpenter_tpu_torch.cloudprovider.aws.fake import ec2api as port_ec2api
from karpenter_tpu_torch.utils import clock as port_clock
from karpenter_tpu_torch.cloudprovider.aws.fake.stubserver import (
    AwsStubServer, REGION, error_xml, fleet_request, tag_filters,
)

PACKAGES = {"jax": (jax_ac, jax_sdk), "port": (port_ac, port_sdk)}
SEEDS = (1, 7, 42)
EXAMPLE_SECRET = "wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY"
NOW = 1_760_000_000.0


def as_dict(x):
    """A dataclass (or a list of them) of either package as plain data."""
    if isinstance(x, list):
        return [as_dict(i) for i in x]
    return dataclasses.asdict(x)


# -- SigV4 -----------------------------------------------------------------------

def test_derived_signing_key_documented_example():
    key = port_sigv4.derive_signing_key(EXAMPLE_SECRET, "20120215", "us-east-1", "iam")
    assert key.hex() == "f4780e2d9f65fa895f9c67b32ce1baf0b0d8a43505a000a1a9e090d414db404d"


def test_get_listusers_documented_example():
    headers = {"content-type": "application/x-www-form-urlencoded; charset=utf-8",
               "host": "iam.amazonaws.com", "x-amz-date": "20150830T123600Z"}
    q = port_sigv4.canonical_query({"Action": "ListUsers", "Version": "2010-05-08"})
    canon, signed = port_sigv4.canonical_request("GET", "/", q, headers,
                                                 port_sigv4.sha256_hex(b""))
    assert port_sigv4.sha256_hex(canon.encode()) == (
        "f536975d06c0309214f805bb90ccff089219ecd68b2577efef23edd43b7e1a59")
    assert signed == "content-type;host;x-amz-date"
    out = port_sigv4.sign(
        method="GET", host="iam.amazonaws.com", path="/",
        query_params={"Action": "ListUsers", "Version": "2010-05-08"},
        headers={"content-type": "application/x-www-form-urlencoded; charset=utf-8"},
        payload=b"", access_key="AKIDEXAMPLE", secret_key=EXAMPLE_SECRET,
        region="us-east-1", service="iam", amz_date="20150830T123600Z")
    assert out["authorization"] == (
        "AWS4-HMAC-SHA256 Credential=AKIDEXAMPLE/20150830/us-east-1/iam/aws4_request, "
        "SignedHeaders=content-type;host;x-amz-date, "
        "Signature=5d672d79c15b13162d9279b0855cfba6789a8edb4c82c400e06b5924a6f2b5d7")


def _word(rng, alphabet="abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
                        "-_.~ /+=%&:"):
    return "".join(rng.choice(alphabet) for _ in range(rng.randint(1, 12)))


@pytest.mark.parametrize("seed", SEEDS)
def test_signatures_equal_the_jax_signer(seed):
    rng = random.Random(seed)
    for _ in range(20):
        kwargs = dict(
            method=rng.choice(["GET", "POST", "put"]),
            host=rng.choice(["ec2.us-east-1.amazonaws.com", "127.0.0.1:8123"]),
            path=rng.choice(["/", "", "/a/b"]),
            query_params={_word(rng): _word(rng) for _ in range(rng.randint(0, 4))},
            headers={rng.choice(["Content-Type", "x-amz-target", "X-Extra"]): " " + _word(rng)
                     for _ in range(rng.randint(0, 3))},
            payload=_word(rng).encode() * rng.randint(0, 3),
            access_key=_word(rng), secret_key=_word(rng),
            region=rng.choice(["us-east-1", "eu-west-3", REGION]),
            service=rng.choice(["ec2", "ssm", "iam"]),
            amz_date=f"20{rng.randint(10, 40)}0{rng.randint(1, 9)}1{rng.randint(0, 9)}T"
                     f"{rng.randint(10, 23)}{rng.randint(10, 59)}{rng.randint(10, 59)}Z",
            session_token=rng.choice([None, "", _word(rng)]))
        assert port_sigv4.sign(**kwargs) == jax_sigv4.sign(**kwargs)
        assert port_sigv4.canonical_query(kwargs["query_params"]) == \
            jax_sigv4.canonical_query(kwargs["query_params"])
        args = (kwargs["secret_key"], kwargs["amz_date"][:8], kwargs["region"],
                kwargs["service"])
        assert port_sigv4.derive_signing_key(*args) == jax_sigv4.derive_signing_key(*args)


def _nested(rng, depth=0):
    kind = rng.randrange(6 if depth < 3 else 3)
    if kind == 0:
        return _word(rng)
    if kind == 1:
        return rng.choice([True, False, None, rng.randint(-5, 500), rng.random()])
    if kind == 2:
        return rng.uniform(0, 10)
    if kind == 3:
        return [_nested(rng, depth + 1) for _ in range(rng.randint(0, 4))]
    if kind == 4:
        return tuple(_nested(rng, depth + 1) for _ in range(rng.randint(0, 3)))
    return {_word(rng, "ABCDEFGHIJ"): _nested(rng, depth + 1) for _ in range(rng.randint(0, 4))}


@pytest.mark.parametrize("seed", SEEDS)
def test_flatten_params_equals_the_jax_flattening(seed):
    rng = random.Random(seed)
    for _ in range(30):
        params = {_word(rng, "ABCDEFGHIJ"): _nested(rng) for _ in range(rng.randint(1, 5))}
        assert port_ac.flatten_params(params) == jax_ac.flatten_params(params)


# -- the clients against the stub ------------------------------------------------

def catalog_infos(n=250):
    """``n`` instance types (three pages of DescribeInstanceTypes) with
    GPUs, accelerators, both architectures and the filtered kinds."""
    infos = []
    for i in range(n):
        info = port_sdk.InstanceTypeInfo(
            instance_type=f"{'mcrgp'[i % 5]}{i}.{['large', 'xlarge', 'metal'][i % 3]}",
            vcpus=1 + i % 64, memory_mib=512 * (1 + i % 48),
            maximum_network_interfaces=1 + i % 8, ipv4_addresses_per_interface=2 + i % 30,
            bare_metal=i % 3 == 2, fpga=i % 17 == 0,
            supported_architectures=["arm64"] if i % 7 == 0 else ["x86_64"],
            supported_usage_classes=["on-demand"] if i % 4 == 0 else ["on-demand", "spot"],
            inference_accelerator_count=i % 11 == 0 and 2 or 0, price_per_hour=0.01 * i)
        if i % 5 == 4:
            info.gpus = [port_sdk.GPUInfo("NVIDIA" if i % 2 else "AMD", 1 + i % 4)]
        infos.append(info)
    return infos


@pytest.fixture()
def stub(monkeypatch):
    """A stub endpoint over a fresh fake of 250 types, its id counter from 1."""
    monkeypatch.setattr(port_ec2api, "_counter", itertools.count(1))
    ec2 = port_ec2api.FakeEC2API(port_ec2api.EC2Behavior(
        describe_instance_types_output=catalog_infos(),
        insufficient_capacity_pools=[port_ec2api.CapacityPool("m5.large", "test-zone-1a",
                                                              "spot")]))
    server = AwsStubServer(ec2, log=True)
    yield server
    server.stop()


def clients(pkg, url, token=None, retryer=None):
    ac, _ = PACKAGES[pkg]
    creds = ac.CredentialProvider()
    creds._cached = ac.Credentials("AK-TEST", "SK-TEST", token)
    retryer = retryer or ac.Retryer(sleep=lambda s: None, rand=lambda: 0.5)
    ec2 = ac.Ec2Client(ac.AwsHttp("ec2", REGION, creds, endpoint=url, retryer=retryer,
                                  now=lambda: NOW))
    ssm = ac.SsmClient(ac.AwsHttp("ssm", REGION, creds, endpoint=url, retryer=retryer,
                                  now=lambda: NOW))
    return ec2, ssm


def script(pkg, url):
    """Every EC2API and SSMAPI call, in an order that exercises each answer;
    the parsed answers as plain data."""
    _, sdk = PACKAGES[pkg]
    ec2, ssm = clients(pkg, url, token="TOK-1")
    out = {"types": as_dict(ec2.describe_instance_types()),
           "offerings": as_dict(ec2.describe_instance_type_offerings()),
           "subnets_wildcard": as_dict(ec2.describe_subnets({"Name": "*"})),
           "subnets_exact": as_dict(ec2.describe_subnets({"Name": "test-subnet-2"})),
           "subnets_multi": as_dict(ec2.describe_subnets(
               {"Name": "test-subnet-1,test-subnet-3", "TestTag": "*"})),
           "groups": as_dict(ec2.describe_security_groups({"Name": "*"})),
           "templates_missing": as_dict(ec2.describe_launch_templates(["nope"]))}
    created = ec2.create_launch_template(sdk.LaunchTemplate(
        launch_template_name="kt-abc", user_data="IyEvYmluL2Jhc2g=", image_id="ami-1",
        instance_profile="karpenter", security_group_ids=["sg-1", "sg-2"],
        metadata_options={"httpTokens": "required", "httpPutResponseHopLimit": 2},
        tags={"Name": "karpenter", "team": "ml"}))
    out["created"] = as_dict(created)
    out["templates"] = as_dict(ec2.describe_launch_templates(["kt-abc"]))
    overrides = [sdk.FleetOverride(instance_type=t, subnet_id=s, availability_zone=z,
                                   priority=float(i))
                 for i, (t, s, z) in enumerate([("m5.large", "test-subnet-1", "test-zone-1a"),
                                                ("c1.xlarge", "test-subnet-2",
                                                 "test-zone-1b")])]
    fleet = ec2.create_fleet(sdk.CreateFleetRequest(
        launch_template_configs=[sdk.FleetLaunchTemplateConfig(
            launch_template_name="kt-abc", overrides=overrides)],
        total_target_capacity=3, default_target_capacity_type="spot",
        allocation_strategy="capacity-optimized-prioritized",
        tags={"kubernetes.io/cluster/c": "owned", "karpenter.sh/launch-nonce": "n-1"}))
    out["fleet"] = as_dict(fleet)
    out["by_id"] = as_dict(ec2.describe_instances(fleet.instance_ids))
    out["by_tags"] = as_dict(ec2.describe_instances_by_tags(
        {"kubernetes.io/cluster/c": "owned"}))
    ec2.terminate_instances(fleet.instance_ids[:1])
    with pytest.raises(sdk.EC2Error) as gone:
        ec2.terminate_instances(fleet.instance_ids[:1])
    out["gone"] = (gone.value.code, gone.value.is_not_found)
    out["ami"] = ssm.get_parameter(
        "/aws/service/eks/optimized-ami/1.21/amazon-linux-2/recommended/image_id")
    return out


def run_script(pkg, server, monkeypatch):
    """``script`` on the stub's fake set back to its start: one stub for
    both packages, so the Host header (the port) signs alike."""
    monkeypatch.setattr(port_ec2api, "_counter", itertools.count(1))
    server.ec2.reset()
    server.ec2.behavior.describe_instance_types_output = catalog_infos()
    server.ec2.behavior.insufficient_capacity_pools = [
        port_ec2api.CapacityPool("m5.large", "test-zone-1a", "spot")]
    server.ssm.reset()
    server.log.clear()
    server.counts.clear()
    # the fake stamps launch times on the port's clock, to the second: a
    # wall clock would give the two runs different times across a second
    port_clock.DEFAULT.set(NOW)
    try:
        out = script(pkg, server.url)
    finally:
        port_clock.DEFAULT.reset()
    return out, list(server.log), dict(server.counts)


def test_clients_make_the_jax_requests_and_parse_the_same_answers(stub, monkeypatch):
    want, want_log, want_counts = run_script("jax", stub, monkeypatch)
    got, got_log, got_counts = run_script("port", stub, monkeypatch)
    assert got_log == want_log
    assert got == want
    assert got_counts == want_counts
    assert got_counts["DescribeInstanceTypes"] == 3  # 250 types, 100 a page


def test_the_wire_catalog_is_the_fakes_less_what_ec2_does_not_return(stub):
    ec2, _ = clients("port", stub.url)
    want = [dataclasses.replace(i, price_per_hour=0.0, pod_eni_trunking_compatible=False,
                                pod_eni_branch_interfaces=0) for i in catalog_infos()]
    assert ec2.describe_instance_types() == want
    assert [log["form"].get("NextToken") for log in stub.log] == [None, "100", "200"]


def test_every_request_is_signed_for_its_service(stub):
    ec2, ssm = clients("port", stub.url, token="TOK-9")
    ec2.describe_subnets({"Name": "*"})
    ssm.get_parameter("/x/y")
    (e, s) = stub.log
    assert "Credential=AK-TEST/" in e["auth"] and f"/{REGION}/ec2/aws4_request" in e["auth"]
    assert f"/{REGION}/ssm/aws4_request" in s["auth"] and s["target"] == "AmazonSSM.GetParameter"
    assert e["token"] == s["token"] == "TOK-9"


def test_the_stub_reads_the_fleet_request_back(stub):
    """The form CreateFleet sends, parsed by the stub, is the request the
    provider built (the in-memory fake's call, field for field)."""
    ec2, _ = clients("port", stub.url)
    request = port_sdk.CreateFleetRequest(
        launch_template_configs=[port_sdk.FleetLaunchTemplateConfig(
            launch_template_name=f"lt-{k}", overrides=[port_sdk.FleetOverride(
                instance_type=f"m{k}.large", subnet_id=f"s-{j}", availability_zone=f"z{j}",
                priority=None if k else float(j)) for j in range(3)]) for k in range(2)],
        total_target_capacity=2, default_target_capacity_type="on-demand",
        allocation_strategy="lowest-price", tags={"a": "1", "karpenter.sh/launch-nonce": "x"})
    ec2.create_fleet(request)
    form = stub.log[-1]["form"]
    assert fleet_request(form) == request
    assert tag_filters(port_ac.flatten_params(
        {"Filter": port_ac.Ec2Client._tag_filters({"k": "*", "v": "a,b"})})) == \
        {"k": "*", "v": "a,b"}


# -- errors and retries ------------------------------------------------------------

def test_retryable_codes_and_parsers_equal_the_jax_package():
    assert port_ac.RETRYABLE_CODES == jax_ac.RETRYABLE_CODES
    bodies = [error_xml("RequestLimitExceeded", "slow").encode(),
              error_xml("InvalidInstanceID.NotFound", "i-1").encode(),
              b"<not-xml", b"<Response/>", "ünïcode".encode()]
    for status in (400, 500, 503):
        for body in bodies:
            p, j = port_ac.parse_ec2_error(status, body), jax_ac.parse_ec2_error(status, body)
            assert (p.code, str(p), p.status, p.is_not_found) == \
                (j.code, str(j), j.status, j.is_not_found)
    for body in (json.dumps({"__type": "com.amazon#ParameterNotFound", "message": "m"}),
                 json.dumps({"Message": "M"}), "{bad"):
        p, j = port_ac.parse_ssm_error(400, body.encode()), \
            jax_ac.parse_ssm_error(400, body.encode())
        assert (p.code, str(p), p.status) == (j.code, str(j), j.status)
    for pkg in PACKAGES.values():
        r = pkg[0].Retryer()
        verdicts = [r.retryable(e) for e in (
            pkg[0].AwsApiError("Throttling", status=400), pkg[0].AwsApiError("X", status=503),
            pkg[0].AwsApiError("InvalidParameterValue", status=400), OSError("reset"),
            ValueError("no"), pkg[1].EC2Error("RequestLimitExceeded"))]
        assert verdicts == [True, True, False, True, False, False]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_retry_schedule_on_the_stub(stub, pkg):
    stub.behavior["fail_next"].extend([
        (503, error_xml("RequestLimitExceeded", "slow")),
        (500, error_xml("InternalError", "oops"))])
    slept = []
    ac, sdk = PACKAGES[pkg]
    ec2, _ = clients(pkg, stub.url, retryer=ac.Retryer(sleep=slept.append, rand=lambda: 1.0))
    assert [s["subnet_id"] for s in as_dict(ec2.describe_subnets({"Name": "*"}))] == \
        ["test-subnet-1", "test-subnet-2", "test-subnet-3"]
    assert len(stub.log) == 3 and slept == [0.2, 0.4]
    stub.behavior["fail_next"].append((400, error_xml("InvalidParameterValue", "bad")))
    with pytest.raises(ac.AwsApiError) as err:
        ec2.describe_subnets({"Name": "*"})
    assert err.value.code == "InvalidParameterValue" and len(stub.log) == 4
    stub.behavior["fail_next"].extend([(503, error_xml("ServiceUnavailable", "x"))] * 3)
    ec2, _ = clients(pkg, stub.url, retryer=ac.Retryer(max_attempts=3, sleep=lambda s: None))
    with pytest.raises(ac.AwsApiError) as err:
        ec2.describe_subnets({"Name": "*"})
    assert err.value.code == "ServiceUnavailable" and len(stub.log) == 7


# -- IMDS and credentials ----------------------------------------------------------

@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_imds_region_and_role_credentials(stub, pkg):
    ac, _ = PACKAGES[pkg]
    imds = ac.Imds(endpoint=stub.url)
    assert imds.region() == REGION
    creds = imds.role_credentials()
    assert (creds.access_key, creds.secret_key, creds.session_token, creds.expiration) == \
        ("ROLE-AK", "ROLE-SK", "ROLE-TOK", 4070908800.0)
    assert not creds.expired()
    assert stub.counts["imds:token"] == 1  # the session token is cached
    imds._token_expiry = 0.0
    imds.region()
    assert stub.counts["imds:token"] == 2


def test_credential_chain_and_region_equal_the_jax_package(stub, monkeypatch, tmp_path):
    def chain(ac):
        provider = ac.CredentialProvider(ac.Imds(endpoint=stub.url))
        got = provider.get()
        assert provider.get() is got  # cached until it expires
        return dataclasses.astuple(got), ac.resolve_region(ac.Imds(endpoint=stub.url))

    for var in ("AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY", "AWS_SESSION_TOKEN",
                "AWS_PROFILE", "AWS_REGION", "AWS_DEFAULT_REGION"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("AWS_SHARED_CREDENTIALS_FILE", str(tmp_path / "none"))
    steps = [chain(port_ac)]
    assert steps[0] == (("ROLE-AK", "ROLE-SK", "ROLE-TOK", 4070908800.0), REGION)
    assert steps[0] == chain(jax_ac)
    (tmp_path / "credentials").write_text(
        "[default]\naws_access_key_id = FILE-AK\naws_secret_access_key = FILE-SK\n"
        "[other]\naws_access_key_id = O-AK\naws_secret_access_key = O-SK\n"
        "aws_session_token = O-TOK\n")
    monkeypatch.setenv("AWS_SHARED_CREDENTIALS_FILE", str(tmp_path / "credentials"))
    monkeypatch.setenv("AWS_DEFAULT_REGION", "eu-default-1")
    assert chain(port_ac) == chain(jax_ac) == (("FILE-AK", "FILE-SK", None, None),
                                                "eu-default-1")
    monkeypatch.setenv("AWS_PROFILE", "other")
    assert chain(port_ac) == chain(jax_ac) == (("O-AK", "O-SK", "O-TOK", None), "eu-default-1")
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "ENV-AK")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "ENV-SK")
    monkeypatch.setenv("AWS_REGION", "eu-env-1")
    assert chain(port_ac) == chain(jax_ac) == (("ENV-AK", "ENV-SK", None, None), "eu-env-1")


def test_default_clients_resolve_the_region_from_the_metadata_service(stub, monkeypatch):
    monkeypatch.delenv("AWS_REGION", raising=False)
    monkeypatch.delenv("AWS_DEFAULT_REGION", raising=False)
    monkeypatch.setenv("AWS_EC2_METADATA_SERVICE_ENDPOINT", stub.url)
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "ENV-AK")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "ENV-SK")
    ec2, ssm = port_ac.default_clients(ec2_endpoint=stub.url, ssm_endpoint=stub.url)
    assert ec2.http.region == ssm.http.region == REGION
    assert [s.subnet_id for s in ec2.describe_subnets({"Name": "test-subnet-3"})] == \
        ["test-subnet-3"]
    assert ssm.get_parameter("/p").startswith("ami-")
    assert "Credential=ENV-AK/" in stub.log[0]["auth"]


def test_the_client_stack_imports_no_sdk():
    import inspect

    src = inspect.getsource(port_ac) + inspect.getsource(port_sdk)
    assert "NotImplementedError" not in src and "boto3" not in src
