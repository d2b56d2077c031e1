"""AWS EC2/SSM clients on stdlib HTTP, with no SDK.

A copy of the JAX package's module. The reference builds an AWS session
with a retryer and an IMDS-discovered region
(pkg/cloudprovider/aws/cloudprovider.go:68-103) and talks to EC2 (query
protocol, XML responses) and SSM (JSON protocol). This module does the
same by hand, in the discipline of runtime/kubeclient.py:

- SigV4 signing (sigv4.py, tested against AWS's published examples);
- credential chain: env → shared credentials file → IMDSv2 instance role,
  with expiry-aware refresh for role credentials;
- region discovery: env → IMDSv2 (placement/region);
- a retryer with exponential backoff and full jitter on throttling/5xx/
  connection errors (cloudprovider.go:83-94's client-side rate limiting
  analog is in instancetypes/instance providers; this is the wire retry);
- ``Ec2Client``/``SsmClient`` implementing the EC2API/SSMAPI seam from
  sdk.py — so the entire provider stack and its tests are transport-
  agnostic, and the fake (fake/ec2api.py) remains drop-in.
"""

from __future__ import annotations

import base64
import calendar
import configparser
import http.client
import json
import logging
import os
import random
import time
import urllib.parse
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from karpenter_tpu_torch.cloudprovider.aws import sdk, sigv4

log = logging.getLogger("karpenter.aws.client")

EC2_API_VERSION = "2016-11-15"
IMDS_ENDPOINT = "http://169.254.169.254"
IMDS_TOKEN_TTL = "21600"

RETRYABLE_CODES = {
    "Throttling", "ThrottlingException", "RequestLimitExceeded",
    "RequestThrottled", "RequestThrottledException", "TooManyRequestsException",
    "ServiceUnavailable", "InternalError", "InternalFailure", "EC2ThrottledException",
}


class AwsApiError(sdk.EC2Error):
    """Wire-level AWS error: carries HTTP status + AWS error code."""

    def __init__(self, code: str, message: str = "", status: int = 0):
        super().__init__(code, message)
        self.status = status


# ---------------------------------------------------------------------------
# Credentials
# ---------------------------------------------------------------------------


@dataclass
class Credentials:
    access_key: str
    secret_key: str
    session_token: Optional[str] = None
    expiration: Optional[float] = None    # epoch seconds; None = static

    def expired(self, now: Optional[float] = None, margin: float = 300.0) -> bool:
        if self.expiration is None:
            return False
        return (now if now is not None else time.time()) > self.expiration - margin


def credentials_from_env(env: Optional[Dict[str, str]] = None) -> Optional[Credentials]:
    env = os.environ if env is None else env
    ak, sk = env.get("AWS_ACCESS_KEY_ID"), env.get("AWS_SECRET_ACCESS_KEY")
    if ak and sk:
        return Credentials(ak, sk, env.get("AWS_SESSION_TOKEN") or None)
    return None


def credentials_from_shared_file(
    path: Optional[str] = None, profile: Optional[str] = None,
) -> Optional[Credentials]:
    path = path or os.environ.get(
        "AWS_SHARED_CREDENTIALS_FILE",
        os.path.expanduser("~/.aws/credentials"))
    profile = profile or os.environ.get("AWS_PROFILE", "default")
    if not os.path.exists(path):
        return None
    cp = configparser.ConfigParser()
    try:
        cp.read(path)
        sec = cp[profile]
        return Credentials(sec["aws_access_key_id"], sec["aws_secret_access_key"],
                           sec.get("aws_session_token") or None)
    except (KeyError, configparser.Error):
        return None


class Imds:
    """IMDSv2: session-token metadata access (the reference resolves its
    region through exactly this service, cloudprovider.go:96-103)."""

    def __init__(self, endpoint: Optional[str] = None, timeout: float = 2.0):
        # AWS_EC2_METADATA_SERVICE_ENDPOINT is the standard SDK override
        endpoint = endpoint or os.environ.get(
            "AWS_EC2_METADATA_SERVICE_ENDPOINT") or IMDS_ENDPOINT
        split = urllib.parse.urlsplit(endpoint)
        self._host = split.hostname or endpoint
        self._port = split.port or 80
        self.timeout = timeout
        self._token: Optional[str] = None
        self._token_expiry = 0.0

    def _req(self, method: str, path: str,
             headers: Optional[Dict[str, str]] = None) -> str:
        conn = http.client.HTTPConnection(self._host, self._port,
                                          timeout=self.timeout)
        try:
            conn.request(method, path, headers=headers or {})
            resp = conn.getresponse()
            body = resp.read().decode()
            if resp.status >= 300:
                raise AwsApiError("IMDSError", f"{method} {path}: {resp.status}",
                                  resp.status)
            return body
        finally:
            conn.close()

    def token(self) -> str:
        # the session token lives IMDS_TOKEN_TTL (6 h) — cache it; IMDS is
        # rate-limited per instance, so two round trips per read would be a
        # throttle hazard on the credential-refresh path
        now = time.monotonic()
        if self._token is None or now >= self._token_expiry:
            self._token = self._req("PUT", "/latest/api/token", {
                "x-aws-ec2-metadata-token-ttl-seconds": IMDS_TOKEN_TTL})
            self._token_expiry = now + float(IMDS_TOKEN_TTL) - 60.0
        return self._token

    def get(self, path: str) -> str:
        return self._req("GET", path, {"x-aws-ec2-metadata-token": self.token()})

    def region(self) -> str:
        return self.get("/latest/meta-data/placement/region").strip()

    def role_credentials(self) -> Credentials:
        role = self.get("/latest/meta-data/iam/security-credentials/").strip()
        role = role.splitlines()[0]
        doc = json.loads(self.get(
            f"/latest/meta-data/iam/security-credentials/{role}"))
        exp = None
        if doc.get("Expiration"):
            try:
                # Expiration is UTC ("...Z") — timegm, NOT mktime (which
                # would skew the epoch by the host's UTC offset and keep
                # serving dead credentials for hours)
                exp = float(calendar.timegm(time.strptime(
                    doc["Expiration"].rstrip("Z"), "%Y-%m-%dT%H:%M:%S")))
            except ValueError:
                exp = None
        return Credentials(doc["AccessKeyId"], doc["SecretAccessKey"],
                           doc.get("Token"), expiration=exp)


def resolve_region(imds: Optional[Imds] = None) -> str:
    region = os.environ.get("AWS_REGION") or os.environ.get("AWS_DEFAULT_REGION")
    if region:
        return region
    return (imds or Imds()).region()


class CredentialProvider:
    """Chain resolver with caching + expiry-aware refresh."""

    def __init__(self, imds: Optional[Imds] = None):
        self.imds = imds
        self._cached: Optional[Credentials] = None

    def get(self) -> Credentials:
        if self._cached is not None and not self._cached.expired():
            return self._cached
        creds = credentials_from_env() or credentials_from_shared_file()
        if creds is None:
            creds = (self.imds or Imds()).role_credentials()
        self._cached = creds
        return creds


# ---------------------------------------------------------------------------
# Retry + transport
# ---------------------------------------------------------------------------


class Retryer:
    """Exponential backoff with full jitter (the AWS-recommended policy;
    the reference's session uses client.DefaultRetryer)."""

    def __init__(self, max_attempts: int = 5, base_s: float = 0.2,
                 cap_s: float = 5.0,
                 sleep: Callable[[float], None] = time.sleep,
                 rand: Callable[[], float] = random.random):
        self.max_attempts = max_attempts
        self.base_s = base_s
        self.cap_s = cap_s
        self.sleep = sleep
        self.rand = rand

    def retryable(self, err: Exception) -> bool:
        if isinstance(err, AwsApiError):
            return (err.status in (429, 500, 502, 503, 504)
                    or err.code in RETRYABLE_CODES)
        return isinstance(err, (OSError, http.client.HTTPException))

    def run(self, fn: Callable[[], object]):
        last: Optional[Exception] = None
        for attempt in range(self.max_attempts):
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 — filtered by retryable()
                if not self.retryable(e):
                    raise
                last = e
                if attempt < self.max_attempts - 1:
                    delay = self.rand() * min(self.cap_s,
                                              self.base_s * (2 ** attempt))
                    log.debug("aws retry %d/%d after %.2fs: %s",
                              attempt + 1, self.max_attempts, delay, e)
                    self.sleep(delay)
        raise last  # type: ignore[misc]


class AwsHttp:
    """One signed POST per call against a single AWS service endpoint."""

    def __init__(
        self,
        service: str,
        region: str,
        credentials: CredentialProvider,
        endpoint: Optional[str] = None,     # override for tests/VPC endpoints
        retryer: Optional[Retryer] = None,
        timeout: float = 30.0,
        now: Callable[[], float] = time.time,
    ):
        self.service = service
        self.region = region
        self.credentials = credentials
        self.retryer = retryer or Retryer()
        self.timeout = timeout
        self.now = now
        url = endpoint or f"https://{service}.{region}.amazonaws.com"
        split = urllib.parse.urlsplit(url)
        self._https = split.scheme == "https"
        self._host = split.hostname or url
        self._port = split.port or (443 if self._https else 80)
        # Host header must include a non-default port (stub servers)
        default = (443 if self._https else 80)
        self._host_header = (self._host if split.port in (None, default)
                             else f"{self._host}:{split.port}")

    def _conn(self):
        if self._https:
            return http.client.HTTPSConnection(self._host, self._port,
                                               timeout=self.timeout)
        return http.client.HTTPConnection(self._host, self._port,
                                          timeout=self.timeout)

    def _post(self, body: bytes, content_type: str,
              extra_headers: Dict[str, str],
              parse_error: Callable[[int, bytes], AwsApiError]) -> bytes:
        def attempt() -> bytes:
            creds = self.credentials.get()
            amz_date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime(self.now()))
            headers = sigv4.sign(
                method="POST", host=self._host_header, path="/",
                query_params={}, headers={"content-type": content_type,
                                          **extra_headers},
                payload=body, access_key=creds.access_key,
                secret_key=creds.secret_key, region=self.region,
                service=self.service, amz_date=amz_date,
                session_token=creds.session_token)
            conn = self._conn()
            try:
                conn.request("POST", "/", body=body, headers=headers)
                resp = conn.getresponse()
                data = resp.read()
                if resp.status >= 300:
                    raise parse_error(resp.status, data)
                return data
            finally:
                conn.close()

        return self.retryer.run(attempt)  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# EC2 (query protocol, XML)
# ---------------------------------------------------------------------------


def flatten_params(params: Dict[str, object]) -> Dict[str, str]:
    """AWS query-protocol flattening: lists → Key.N, dicts → Key.Sub."""
    out: Dict[str, str] = {}

    def walk(prefix: str, v: object):
        if isinstance(v, dict):
            for k, sub in v.items():
                walk(f"{prefix}.{k}" if prefix else str(k), sub)
        elif isinstance(v, (list, tuple)):
            for i, sub in enumerate(v, start=1):
                walk(f"{prefix}.{i}", sub)
        elif isinstance(v, bool):
            out[prefix] = "true" if v else "false"
        elif v is not None:
            out[prefix] = str(v)

    walk("", dict(params))
    return out


def _strip_ns(root: ET.Element) -> ET.Element:
    for el in root.iter():
        if "}" in el.tag:
            el.tag = el.tag.split("}", 1)[1]
    return root


def _text(el: Optional[ET.Element], default: str = "") -> str:
    return el.text.strip() if el is not None and el.text else default


def _int(el: Optional[ET.Element], default: int = 0) -> int:
    try:
        return int(_text(el))
    except ValueError:
        return default


def parse_ec2_error(status: int, body: bytes) -> AwsApiError:
    """<Response><Errors><Error><Code>…</Code><Message>…</Message>…"""
    try:
        root = _strip_ns(ET.fromstring(body.decode()))
        err = root.find(".//Error")
        if err is not None:
            return AwsApiError(_text(err.find("Code"), "UnknownError"),
                               _text(err.find("Message")), status)
    except ET.ParseError:
        pass
    return AwsApiError("UnknownError", body[:200].decode(errors="replace"),
                       status)


def _launch_unix(iso: str) -> float:
    """EC2 launchTime (ISO8601 UTC, optional fractional seconds) → unix
    seconds; 0.0 when absent/unparseable (reads as infinitely old, which
    errs toward GC eligibility only after the grace window anyway)."""
    if not iso:
        return 0.0
    base = iso.split(".")[0].rstrip("Z")
    try:
        return float(calendar.timegm(time.strptime(base, "%Y-%m-%dT%H:%M:%S")))
    except ValueError:
        return 0.0


def _tagset(el: Optional[ET.Element]) -> Dict[str, str]:
    tags = {}
    if el is not None:
        for item in el.findall("item"):
            tags[_text(item.find("key"))] = _text(item.find("value"))
    return tags


class Ec2Client(sdk.EC2API):
    """EC2API over the wire. Pagination is followed to exhaustion; tag
    filters use the same '*'-means-tag-key-wildcard convention as the
    provider (aws/subnets.go:63-76)."""

    def __init__(self, http_client: AwsHttp):
        self.http = http_client

    # -- plumbing ---------------------------------------------------------
    def _call(self, action: str, params: Dict[str, object]) -> ET.Element:
        form = {"Action": action, "Version": EC2_API_VERSION,
                **flatten_params(params)}
        body = urllib.parse.urlencode(sorted(form.items())).encode()
        data = self.http._post(
            body, "application/x-www-form-urlencoded; charset=utf-8", {},
            parse_ec2_error)
        return _strip_ns(ET.fromstring(data.decode()))

    def _paged(self, action: str, params: Dict[str, object]):
        token = None
        while True:
            p = dict(params)
            if token:
                p["NextToken"] = token
            root = self._call(action, p)
            yield root
            token = _text(root.find("nextToken")) or None
            if not token:
                return

    @staticmethod
    def _tag_filters(tag_filters: Dict[str, str]) -> List[Dict[str, object]]:
        filters: List[Dict[str, object]] = []
        for key, value in tag_filters.items():
            if value == "*":
                filters.append({"Name": "tag-key", "Value": [key]})
            else:
                filters.append({"Name": f"tag:{key}",
                                "Value": value.split(",")})
        return filters

    # -- operations -------------------------------------------------------
    def describe_instance_types(self) -> List[sdk.InstanceTypeInfo]:
        out: List[sdk.InstanceTypeInfo] = []
        for root in self._paged("DescribeInstanceTypes", {"MaxResults": 100}):
            for item in root.findall(".//instanceTypeSet/item"):
                gpus = [sdk.GPUInfo(
                    manufacturer=_text(g.find("manufacturer")),
                    count=_int(g.find("count")))
                    for g in item.findall("gpuInfo/gpus/item")]
                accels = sum(
                    _int(a.find("count"))
                    for a in item.findall("inferenceAcceleratorInfo/accelerators/item"))
                net = item.find("networkInfo")
                out.append(sdk.InstanceTypeInfo(
                    instance_type=_text(item.find("instanceType")),
                    supported_architectures=[
                        _text(a) for a in item.findall(
                            "processorInfo/supportedArchitectures/item")],
                    supported_usage_classes=[
                        _text(u) for u in item.findall("supportedUsageClasses/item")],
                    supported_virtualization_types=[
                        _text(v) for v in item.findall(
                            "supportedVirtualizationTypes/item")],
                    vcpus=_int(item.find("vCpuInfo/defaultVCpus")),
                    memory_mib=_int(item.find("memoryInfo/sizeInMiB")),
                    gpus=gpus,
                    inference_accelerator_count=accels,
                    maximum_network_interfaces=_int(
                        net.find("maximumNetworkInterfaces") if net is not None else None),
                    ipv4_addresses_per_interface=_int(
                        net.find("ipv4AddressesPerInterface") if net is not None else None),
                    bare_metal=_text(item.find("bareMetal")) == "true",
                    fpga=item.find("fpgaInfo") is not None,
                ))
        return out

    def describe_instance_type_offerings(self) -> List[sdk.InstanceTypeOffering]:
        out = []
        for root in self._paged("DescribeInstanceTypeOfferings",
                                {"LocationType": "availability-zone"}):
            for item in root.findall(".//instanceTypeOfferingSet/item"):
                out.append(sdk.InstanceTypeOffering(
                    instance_type=_text(item.find("instanceType")),
                    location=_text(item.find("location"))))
        return out

    def describe_subnets(self, tag_filters: Dict[str, str]) -> List[sdk.Subnet]:
        params = {"Filter": self._tag_filters(tag_filters)}
        out = []
        for root in self._paged("DescribeSubnets", params):
            for item in root.findall(".//subnetSet/item"):
                out.append(sdk.Subnet(
                    subnet_id=_text(item.find("subnetId")),
                    availability_zone=_text(item.find("availabilityZone")),
                    tags=_tagset(item.find("tagSet"))))
        return out

    def describe_security_groups(
            self, tag_filters: Dict[str, str]) -> List[sdk.SecurityGroup]:
        params = {"Filter": self._tag_filters(tag_filters)}
        out = []
        for root in self._paged("DescribeSecurityGroups", params):
            for item in root.findall(".//securityGroupInfo/item"):
                out.append(sdk.SecurityGroup(
                    group_id=_text(item.find("groupId")),
                    group_name=_text(item.find("groupName")),
                    tags=_tagset(item.find("tagSet"))))
        return out

    def describe_launch_templates(self, names: List[str]) -> List[sdk.LaunchTemplate]:
        try:
            root = self._call("DescribeLaunchTemplates",
                              {"LaunchTemplateName": list(names)})
        except AwsApiError as e:
            if "NotFound" in e.code:
                return []
            raise
        return [
            sdk.LaunchTemplate(
                launch_template_name=_text(item.find("launchTemplateName")),
                launch_template_id=_text(item.find("launchTemplateId")))
            for item in root.findall(".//launchTemplates/item")
        ]

    def create_launch_template(self, template: sdk.LaunchTemplate) -> sdk.LaunchTemplate:
        data: Dict[str, object] = {
            "ImageId": template.image_id,
            "UserData": base64.b64encode(template.user_data.encode()).decode(),
            "SecurityGroupId": list(template.security_group_ids),
        }
        if template.instance_profile:
            data["IamInstanceProfile"] = {"Name": template.instance_profile}
        if template.metadata_options:
            data["MetadataOptions"] = dict(template.metadata_options)
        params: Dict[str, object] = {
            "LaunchTemplateName": template.launch_template_name,
            "LaunchTemplateData": data,
        }
        if template.tags:
            params["TagSpecification"] = [{
                "ResourceType": "launch-template",
                "Tag": [{"Key": k, "Value": v} for k, v in template.tags.items()],
            }]
        root = self._call("CreateLaunchTemplate", params)
        lt = root.find(".//launchTemplate")
        template.launch_template_id = _text(
            lt.find("launchTemplateId") if lt is not None else None)
        return template

    def create_fleet(self, request: sdk.CreateFleetRequest) -> sdk.CreateFleetResponse:
        configs: List[Dict[str, object]] = []
        for cfg in request.launch_template_configs:
            overrides = []
            for o in cfg.overrides:
                ov: Dict[str, object] = {"InstanceType": o.instance_type,
                                         "SubnetId": o.subnet_id}
                if o.availability_zone:
                    ov["AvailabilityZone"] = o.availability_zone
                if o.priority is not None:
                    ov["Priority"] = o.priority
                overrides.append(ov)
            configs.append({
                "LaunchTemplateSpecification": {
                    "LaunchTemplateName": cfg.launch_template_name,
                    "Version": cfg.version,
                },
                "Overrides": overrides,
            })
        params: Dict[str, object] = {
            "Type": request.fleet_type,
            "LaunchTemplateConfigs": configs,
            "TargetCapacitySpecification": {
                "TotalTargetCapacity": request.total_target_capacity,
                "DefaultTargetCapacityType": request.default_target_capacity_type,
            },
            # the reference launches spot with capacity-optimized-prioritized
            # so Priority on overrides is honored (aws/instance.go:122-131)
            "OnDemandOptions": {"AllocationStrategy": "lowest-price"},
            "SpotOptions": {
                "AllocationStrategy": request.allocation_strategy
                or "capacity-optimized-prioritized"},
        }
        if request.tags:
            params["TagSpecification"] = [{
                "ResourceType": "instance",
                "Tag": [{"Key": k, "Value": v} for k, v in request.tags.items()],
            }]
        root = self._call("CreateFleet", params)
        ids = [
            _text(i) for i in root.findall(".//fleetInstanceSet/item/instanceIds/item")
        ]
        errors = []
        for err in root.findall(".//errorSet/item"):
            ov = err.find("launchTemplateAndOverrides/overrides")
            errors.append(sdk.CreateFleetError(
                error_code=_text(err.find("errorCode")),
                error_message=_text(err.find("errorMessage")),
                instance_type=_text(ov.find("instanceType") if ov is not None else None),
                availability_zone=_text(
                    ov.find("availabilityZone") if ov is not None else None)))
        return sdk.CreateFleetResponse(instance_ids=ids, errors=errors)

    def describe_instances(self, instance_ids: List[str]) -> List[sdk.Instance]:
        out = []
        for root in self._paged("DescribeInstances",
                                {"InstanceId": list(instance_ids)}):
            out.extend(self._parse_instances(root))
        return out

    def describe_instances_by_tags(
            self, tag_filters: Dict[str, str]) -> List[sdk.Instance]:
        params = {"Filter": self._tag_filters(tag_filters),
                  "MaxResults": 1000}
        out = []
        for root in self._paged("DescribeInstances", params):
            out.extend(self._parse_instances(root))
        return out

    @staticmethod
    def _parse_instances(root: ET.Element) -> List[sdk.Instance]:
        out = []
        for item in root.findall(".//reservationSet/item/instancesSet/item"):
            out.append(sdk.Instance(
                instance_id=_text(item.find("instanceId")),
                instance_type=_text(item.find("instanceType")),
                availability_zone=_text(item.find("placement/availabilityZone")),
                private_dns_name=_text(item.find("privateDnsName")),
                image_id=_text(item.find("imageId")),
                architecture=_text(item.find("architecture"), "x86_64"),
                spot_instance_request_id=_text(
                    item.find("spotInstanceRequestId")) or None,
                tags=_tagset(item.find("tagSet")),
                launch_time=_launch_unix(_text(item.find("launchTime"))),
                state=_text(item.find("instanceState/name"), "running")))
        return out

    def terminate_instances(self, instance_ids: List[str]) -> None:
        self._call("TerminateInstances", {"InstanceId": list(instance_ids)})


# ---------------------------------------------------------------------------
# SSM (JSON protocol)
# ---------------------------------------------------------------------------


def parse_ssm_error(status: int, body: bytes) -> AwsApiError:
    try:
        doc = json.loads(body.decode())
        code = (doc.get("__type") or "UnknownError").split("#")[-1]
        return AwsApiError(code, doc.get("message") or doc.get("Message", ""),
                           status)
    except ValueError:
        return AwsApiError("UnknownError",
                           body[:200].decode(errors="replace"), status)


class SsmClient(sdk.SSMAPI):
    """GetParameter — resolves EKS-optimized AMI ids (aws/ami.go:40-100)."""

    def __init__(self, http_client: AwsHttp):
        self.http = http_client

    def get_parameter(self, name: str) -> str:
        body = json.dumps({"Name": name}).encode()
        data = self.http._post(
            body, "application/x-amz-json-1.1",
            {"x-amz-target": "AmazonSSM.GetParameter"}, parse_ssm_error)
        doc = json.loads(data.decode())
        return str((doc.get("Parameter") or {}).get("Value", ""))


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------


def default_clients(
    region: Optional[str] = None,
    ec2_endpoint: Optional[str] = None,
    ssm_endpoint: Optional[str] = None,
):
    """Build (Ec2Client, SsmClient) from the ambient environment — the
    counterpart of the reference's session construction
    (cloudprovider.go:68-103): region from env or IMDS, credential chain,
    shared retryer policy."""
    imds = Imds()
    region = region or resolve_region(imds)
    creds = CredentialProvider(imds)
    ec2 = Ec2Client(AwsHttp("ec2", region, creds, endpoint=ec2_endpoint))
    ssm = SsmClient(AwsHttp("ssm", region, creds, endpoint=ssm_endpoint))
    return ec2, ssm
