"""Stub AWS endpoint over HTTP, backed by the port's ``FakeEC2API`` and
``FakeSSMAPI``.

A test double, never part of the controller process: ``main.py`` does not
import it. The CPU tests and ``chip_smoke.py`` point the AWS clients
(awsclient.py) at it, so every EC2, SSM and instance-metadata call crosses a
socket through the SigV4 signer, the query-protocol flattening and the XML
and JSON parsers. It grew out of the JAX package's test stub
(tests/test_aws_client.py), answering from one fake's state instead of
canned pages. One port serves:

- EC2's query protocol (form-encoded ``POST /``, XML answers in the
  2016-11-15 namespace): DescribeInstanceTypes (paged by ``MaxResults``,
  100 unless asked, with ``nextToken`` as EC2 pages it),
  DescribeInstanceTypeOfferings, DescribeSubnets, DescribeSecurityGroups
  (tag filters: ``tag-key`` and ``tag:<key>``), DescribeLaunchTemplates
  (InvalidLaunchTemplateName.NotFoundException when none exists),
  CreateLaunchTemplate, CreateFleet, DescribeInstances (by id, or by tag
  filter paged by ``MaxResults``) and TerminateInstances; a fake's
  ``EC2Error`` answers 400 with its code;
- SSM's JSON protocol (``x-amz-target: AmazonSSM.GetParameter``);
- IMDSv2: ``PUT /latest/api/token``, then the region and one role's
  credentials under ``/latest/meta-data/`` with that token.

What EC2 does not return is not served: the fake's ``price_per_hour`` and
pod-ENI trunking fields stay in the stub (the reference reads them from
other sources), so a client sees them as zero.

Faults and records:

- ``behavior["fail_next"]``: a list of ``(status, body)`` answers served,
  first to last, before any EC2 or SSM call is handled;
- ``counts``: requests by action (``"CreateFleet"``, ``"ssm:GetParameter"``,
  ``"imds:token"``, ...);
- with ``log=True``, ``log`` keeps every EC2 and SSM request as a dict of
  its ``form``, ``target``, ``auth``, ``token`` and ``body``.

``GET /stub/state`` returns the counts, the live instances (with their
tags) and the terminated ids. Run ``python -m
karpenter_tpu_torch.cloudprovider.aws.fake.stubserver [--port N]
[--behavior FILE]`` for a server of its own process: ``FILE`` is the JSON
of an :class:`EC2Behavior` (:func:`behavior_to_json`); it prints
``{"url": ...}`` and serves until SIGTERM.
"""

from __future__ import annotations

import argparse
import base64
import dataclasses
import json
import signal
import sys
import threading
import time
import urllib.parse
from collections import Counter
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional
from xml.sax.saxutils import escape

from karpenter_tpu_torch.cloudprovider.aws import sdk
from karpenter_tpu_torch.cloudprovider.aws.fake.ec2api import (
    CapacityPool, EC2Behavior, FakeEC2API,
)
from karpenter_tpu_torch.cloudprovider.aws.fake.ssmapi import FakeSSMAPI

XMLNS = "http://ec2.amazonaws.com/doc/2016-11-15/"
IMDS_TOKEN = "STUB-TOKEN"
REGION = "us-stub-1"
ROLE = "stub-role"
ROLE_CREDENTIALS = {"AccessKeyId": "ROLE-AK", "SecretAccessKey": "ROLE-SK",
                    "Token": "ROLE-TOK", "Expiration": "2099-01-01T00:00:00Z"}
DESCRIBE_INSTANCE_TYPES_PAGE = 100
OFFERINGS_PAGE = 1000


# -- JSON of the fake's behavior (the child process's --behavior file) --------

def behavior_to_json(behavior: EC2Behavior) -> str:
    return json.dumps(dataclasses.asdict(behavior))


def behavior_from_json(text: str) -> EC2Behavior:
    doc = json.loads(text)

    def listed(key, cls, convert=None):
        items = doc.get(key)
        if items is None:
            return None
        return [convert(i) if convert else cls(**i) for i in items]

    def info(d):
        return sdk.InstanceTypeInfo(**{**d, "gpus": [sdk.GPUInfo(**g) for g in d["gpus"]]})

    return EC2Behavior(
        describe_instance_types_output=listed("describe_instance_types_output", None, info),
        describe_instance_type_offerings_output=listed(
            "describe_instance_type_offerings_output", sdk.InstanceTypeOffering),
        describe_subnets_output=listed("describe_subnets_output", sdk.Subnet),
        describe_security_groups_output=listed("describe_security_groups_output",
                                               sdk.SecurityGroup),
        describe_instances_output=listed("describe_instances_output", sdk.Instance),
        insufficient_capacity_pools=[CapacityPool(**p) for p in
                                     doc.get("insufficient_capacity_pools") or []])


# -- the query protocol, read back -----------------------------------------------

def _numbered(form: Dict[str, str], prefix: str) -> List[str]:
    """``prefix.1``, ``prefix.2``, ... in order: the members of a list."""
    out, i = [], 1
    while f"{prefix}.{i}" in form:
        out.append(form[f"{prefix}.{i}"])
        i += 1
    return out


def _members(form: Dict[str, str], prefix: str, field: str) -> List[str]:
    """The prefixes ``prefix.1``, ``prefix.2``, ... of a list of structures,
    each of which has ``field``."""
    out, i = [], 1
    while f"{prefix}.{i}.{field}" in form:
        out.append(f"{prefix}.{i}")
        i += 1
    return out


def tag_filters(form: Dict[str, str]) -> Dict[str, str]:
    """``Filter.N`` back into the provider's selector convention: a
    ``tag-key`` filter is ``"*"``, a ``tag:<key>`` filter the values joined
    by commas (Ec2Client._tag_filters read backwards)."""
    out: Dict[str, str] = {}
    for f in _members(form, "Filter", "Name"):
        name, values = form[f"{f}.Name"], _numbered(form, f"{f}.Value")
        if name == "tag-key":
            for key in values:
                out[key] = "*"
        elif name.startswith("tag:"):
            out[name[4:]] = ",".join(values)
    return out


def _tags(form: Dict[str, str], prefix: str) -> Dict[str, str]:
    return {form[f"{t}.Key"]: form.get(f"{t}.Value", "")
            for t in _members(form, f"{prefix}.Tag", "Key")}


def fleet_request(form: Dict[str, str]) -> sdk.CreateFleetRequest:
    configs = []
    for c in _members(form, "LaunchTemplateConfigs",
                      "LaunchTemplateSpecification.LaunchTemplateName"):
        overrides = []
        for o in _members(form, f"{c}.Overrides", "InstanceType"):
            priority = form.get(f"{o}.Priority")
            overrides.append(sdk.FleetOverride(
                instance_type=form[f"{o}.InstanceType"], subnet_id=form[f"{o}.SubnetId"],
                availability_zone=form.get(f"{o}.AvailabilityZone", ""),
                priority=float(priority) if priority is not None else None))
        spec = f"{c}.LaunchTemplateSpecification"
        configs.append(sdk.FleetLaunchTemplateConfig(
            launch_template_name=form.get(f"{spec}.LaunchTemplateName", ""),
            version=form.get(f"{spec}.Version", "$Default"), overrides=overrides))
    tags = {}
    for t in _members(form, "TagSpecification", "ResourceType"):
        tags.update(_tags(form, t))
    return sdk.CreateFleetRequest(
        launch_template_configs=configs,
        total_target_capacity=int(form["TargetCapacitySpecification.TotalTargetCapacity"]),
        default_target_capacity_type=form.get(
            "TargetCapacitySpecification.DefaultTargetCapacityType", "on-demand"),
        fleet_type=form.get("Type", "instant"),
        # the client sends the request's strategy (or the spot default) as
        # the spot options' strategy
        allocation_strategy=form.get("SpotOptions.AllocationStrategy", ""),
        tags=tags)


def launch_template(form: Dict[str, str]) -> sdk.LaunchTemplate:
    data = "LaunchTemplateData"
    metadata = {k[len(f"{data}.MetadataOptions."):]: v for k, v in form.items()
                if k.startswith(f"{data}.MetadataOptions.")}
    tags = {}
    for t in _members(form, "TagSpecification", "ResourceType"):
        tags.update(_tags(form, t))
    return sdk.LaunchTemplate(
        launch_template_name=form["LaunchTemplateName"],
        user_data=base64.b64decode(form.get(f"{data}.UserData", "")).decode(),
        image_id=form.get(f"{data}.ImageId", ""),
        instance_profile=form.get(f"{data}.IamInstanceProfile.Name", ""),
        security_group_ids=_numbered(form, f"{data}.SecurityGroupId"),
        metadata_options=metadata, tags=tags)


# -- XML -----------------------------------------------------------------------

def _el(tag: str, value) -> str:
    return f"<{tag}>{escape(str(value))}</{tag}>"


def _items(values) -> str:
    return "".join(f"<item>{v}</item>" for v in values)


def _tagset(tags: Dict[str, str]) -> str:
    return "<tagSet>" + _items(_el("key", k) + _el("value", v)
                               for k, v in tags.items()) + "</tagSet>"


def _response(action: str, body: str) -> str:
    return f'<{action}Response xmlns="{XMLNS}">{body}</{action}Response>'


def error_xml(code: str, message: str = "") -> str:
    return ("<Response><Errors><Error>" + _el("Code", code) + _el("Message", message)
            + "</Error></Errors></Response>")


def _instance_type_xml(info: sdk.InstanceTypeInfo) -> str:
    parts = [
        _el("instanceType", info.instance_type),
        "<vCpuInfo>" + _el("defaultVCpus", info.vcpus) + "</vCpuInfo>",
        "<memoryInfo>" + _el("sizeInMiB", info.memory_mib) + "</memoryInfo>",
        "<processorInfo><supportedArchitectures>"
        + _items(escape(a) for a in info.supported_architectures)
        + "</supportedArchitectures></processorInfo>",
        "<supportedUsageClasses>" + _items(escape(u) for u in info.supported_usage_classes)
        + "</supportedUsageClasses>",
        "<supportedVirtualizationTypes>"
        + _items(escape(v) for v in info.supported_virtualization_types)
        + "</supportedVirtualizationTypes>",
        "<networkInfo>" + _el("maximumNetworkInterfaces", info.maximum_network_interfaces)
        + _el("ipv4AddressesPerInterface", info.ipv4_addresses_per_interface)
        + "</networkInfo>",
        _el("bareMetal", "true" if info.bare_metal else "false"),
    ]
    if info.gpus:
        parts.append("<gpuInfo><gpus>" + _items(
            _el("manufacturer", g.manufacturer) + _el("count", g.count) for g in info.gpus)
            + "</gpus></gpuInfo>")
    if info.inference_accelerator_count:
        parts.append("<inferenceAcceleratorInfo><accelerators><item>"
                     + _el("count", info.inference_accelerator_count)
                     + "</item></accelerators></inferenceAcceleratorInfo>")
    if info.fpga:
        parts.append("<fpgaInfo/>")
    return "".join(parts)


def _iso(t: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S.000Z", time.gmtime(t))


def _instance_xml(i: sdk.Instance) -> str:
    parts = [_el("instanceId", i.instance_id), _el("instanceType", i.instance_type),
             "<placement>" + _el("availabilityZone", i.availability_zone) + "</placement>",
             _el("privateDnsName", i.private_dns_name), _el("imageId", i.image_id),
             _el("architecture", i.architecture), _tagset(i.tags),
             _el("launchTime", _iso(i.launch_time)),
             "<instanceState>" + _el("name", i.state) + "</instanceState>"]
    if i.spot_instance_request_id:
        parts.append(_el("spotInstanceRequestId", i.spot_instance_request_id))
    return "".join(parts)


def _page(items: list, form: Dict[str, str], size: int):
    """One page of ``items`` from ``NextToken`` (an offset) and the next
    token, or "" on the last page."""
    start = int(form.get("NextToken") or 0)
    size = int(form.get("MaxResults") or size)
    nxt = start + size
    return items[start:nxt], (str(nxt) if nxt < len(items) else "")


# -- the handler ---------------------------------------------------------------

class AwsStubHandler(BaseHTTPRequestHandler):
    ec2: FakeEC2API = None
    ssm: FakeSSMAPI = None
    behavior: dict = None
    counts: Counter = None
    log: Optional[list] = None
    lock: threading.Lock = None
    protocol_version = "HTTP/1.1"
    # the headers and the body go out in two writes (runtime/stubserver.py)
    disable_nagle_algorithm = True

    def log_message(self, *a):
        pass

    def _reply(self, code: int, body, ctype: str = "text/xml") -> None:
        data = body.encode() if isinstance(body, str) else body
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _count(self, what: str) -> None:
        with self.lock:
            self.counts[what] += 1

    # -- IMDSv2 ----------------------------------------------------------------
    def do_PUT(self):
        if self.path == "/latest/api/token":
            self._count("imds:token")
            return self._reply(200, IMDS_TOKEN, "text/plain")
        self._reply(404, "not found", "text/plain")

    def do_GET(self):
        if self.path == "/stub/state":
            with self.lock:
                state = {"counts": dict(self.counts),
                         "instances": [dataclasses.asdict(i)
                                       for i in self.ec2._instances.values()],
                         "terminated": list(self.ec2.terminated)}
            return self._reply(200, json.dumps(state), "application/json")
        if self.headers.get("x-aws-ec2-metadata-token") != IMDS_TOKEN:
            return self._reply(401, "unauthorized", "text/plain")
        self._count("imds:get")
        meta = "/latest/meta-data/"
        answers = {
            meta + "placement/region": (REGION, "text/plain"),
            meta + "iam/security-credentials/": (ROLE + "\n", "text/plain"),
            meta + f"iam/security-credentials/{ROLE}": (json.dumps(ROLE_CREDENTIALS),
                                                        "application/json"),
        }
        if self.path in answers:
            return self._reply(200, *answers[self.path])
        self._reply(404, "not found", "text/plain")

    # -- EC2 and SSM -----------------------------------------------------------
    def do_POST(self):
        body = self.rfile.read(int(self.headers.get("Content-Length") or 0))
        target = self.headers.get("x-amz-target", "")
        form = {} if target else dict(urllib.parse.parse_qsl(body.decode(),
                                                              keep_blank_values=True))
        with self.lock:
            if self.log is not None:
                self.log.append({"form": form, "target": target,
                                 "auth": self.headers.get("authorization", ""),
                                 "token": self.headers.get("x-amz-security-token"),
                                 "body": body.decode()})
            fail = self.behavior.get("fail_next")
            canned = fail.pop(0) if fail else None
        if canned is not None:
            return self._reply(*canned)
        if target == "AmazonSSM.GetParameter":
            self._count("ssm:GetParameter")
            with self.lock:
                value = self.ssm.get_parameter(json.loads(body)["Name"])
            return self._reply(200, json.dumps({"Parameter": {"Value": value}}),
                               "application/x-amz-json-1.1")
        action = form.get("Action", "")
        handler = getattr(self, f"ec2_{action}", None)
        self._count(action or "unknown")
        if handler is None:
            return self._reply(400, error_xml("InvalidAction", action))
        try:
            with self.lock:
                xml = handler(form)
        except sdk.EC2Error as e:
            return self._reply(400, error_xml(e.code, str(e)))
        self._reply(200, _response(action, xml))

    def ec2_DescribeInstanceTypes(self, form):
        infos, token = _page(self.ec2.describe_instance_types(), form,
                             DESCRIBE_INSTANCE_TYPES_PAGE)
        return ("<instanceTypeSet>" + _items(_instance_type_xml(i) for i in infos)
                + "</instanceTypeSet>" + (_el("nextToken", token) if token else ""))

    def ec2_DescribeInstanceTypeOfferings(self, form):
        offerings, token = _page(self.ec2.describe_instance_type_offerings(), form,
                                 OFFERINGS_PAGE)
        return ("<instanceTypeOfferingSet>" + _items(
            _el("instanceType", o.instance_type) + _el("location", o.location)
            for o in offerings) + "</instanceTypeOfferingSet>"
            + (_el("nextToken", token) if token else ""))

    def ec2_DescribeSubnets(self, form):
        return "<subnetSet>" + _items(
            _el("subnetId", s.subnet_id) + _el("availabilityZone", s.availability_zone)
            + _tagset(s.tags) for s in self.ec2.describe_subnets(tag_filters(form))
        ) + "</subnetSet>"

    def ec2_DescribeSecurityGroups(self, form):
        return "<securityGroupInfo>" + _items(
            _el("groupId", g.group_id) + _el("groupName", g.group_name) + _tagset(g.tags)
            for g in self.ec2.describe_security_groups(tag_filters(form))
        ) + "</securityGroupInfo>"

    def ec2_DescribeLaunchTemplates(self, form):
        found = self.ec2.describe_launch_templates(_numbered(form, "LaunchTemplateName"))
        if not found:
            raise sdk.EC2Error("InvalidLaunchTemplateName.NotFoundException",
                               "the specified launch template does not exist")
        return "<launchTemplates>" + _items(
            _el("launchTemplateName", t.launch_template_name)
            + _el("launchTemplateId", t.launch_template_id) for t in found
        ) + "</launchTemplates>"

    def ec2_CreateLaunchTemplate(self, form):
        t = self.ec2.create_launch_template(launch_template(form))
        return ("<launchTemplate>" + _el("launchTemplateName", t.launch_template_name)
                + _el("launchTemplateId", t.launch_template_id) + "</launchTemplate>")

    def ec2_CreateFleet(self, form):
        response = self.ec2.create_fleet(fleet_request(form))
        ids = _items(escape(i) for i in response.instance_ids)
        errors = _items(
            _el("errorCode", e.error_code) + _el("errorMessage", e.error_message)
            + "<launchTemplateAndOverrides><overrides>" + _el("instanceType", e.instance_type)
            + _el("availabilityZone", e.availability_zone)
            + "</overrides></launchTemplateAndOverrides>" for e in response.errors)
        return (f"<fleetInstanceSet><item><instanceIds>{ids}</instanceIds></item>"
                f"</fleetInstanceSet><errorSet>{errors}</errorSet>")

    def ec2_DescribeInstances(self, form):
        ids = _numbered(form, "InstanceId")
        if ids:
            instances, token = self.ec2.describe_instances(ids), ""
        else:
            instances, token = _page(self.ec2.describe_instances_by_tags(tag_filters(form)),
                                     form, 1000)
        return ("<reservationSet><item><instancesSet>"
                + _items(_instance_xml(i) for i in instances)
                + "</instancesSet></item></reservationSet>"
                + (_el("nextToken", token) if token else ""))

    def ec2_TerminateInstances(self, form):
        ids = _numbered(form, "InstanceId")
        self.ec2.terminate_instances(ids)
        return "<instancesSet>" + _items(_el("instanceId", i) for i in ids) + "</instancesSet>"


class AwsStubServer:
    """A running stub: ``url``, the backing ``ec2`` and ``ssm`` fakes, the
    live ``behavior`` dict, the ``counts`` and (with ``log=True``) the
    request ``log``."""

    def __init__(self, ec2: Optional[FakeEC2API] = None, ssm: Optional[FakeSSMAPI] = None,
                 host: str = "127.0.0.1", port: int = 0, log: bool = False):
        self.ec2 = ec2 if ec2 is not None else FakeEC2API()
        self.ssm = ssm if ssm is not None else FakeSSMAPI()
        self.behavior: dict = {"fail_next": []}
        self.counts: Counter = Counter()
        self.log: Optional[List[dict]] = [] if log else None
        handler = type("BoundAwsStub", (AwsStubHandler,), {
            "ec2": self.ec2, "ssm": self.ssm, "behavior": self.behavior,
            "counts": self.counts, "log": self.log, "lock": threading.Lock()})
        server_cls = type("AwsStub", (ThreadingHTTPServer,),
                          {"request_queue_size": 128, "daemon_threads": True})
        self.server = server_cls((host, port), handler)
        self.url = f"http://{host}:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True,
                                       name="stub-aws")
        self.thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="stub AWS endpoint (a test double)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--behavior", default="",
                        help="JSON file of the fake EC2 API's behavior")
    args = parser.parse_args(argv)
    behavior = None
    if args.behavior:
        with open(args.behavior) as f:
            behavior = behavior_from_json(f.read())
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    stub = AwsStubServer(FakeEC2API(behavior), host=args.host, port=args.port)
    print(json.dumps({"url": stub.url}), flush=True)
    try:
        while not stop.wait(0.5):
            pass
    except KeyboardInterrupt:
        pass
    stub.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
