"""AWS Signature Version 4 request signing: pure functions, no I/O.

A copy of the JAX package's module. The reference reaches AWS through
aws-sdk-go, which signs every request with SigV4 (session construction at
pkg/cloudprovider/aws/cloudprovider.go:68-103). The port imports no AWS
SDK, so the algorithm is implemented here; tests hold it against the
worked examples of the SigV4 documentation and against the JAX package's
signer byte for byte (tests/test_torch_aws_client.py).

Algorithm (docs.aws.amazon.com "Signature Version 4 signing process"):
  1. canonical request  = METHOD \n URI \n query \n canonical headers \n
                          signed header names \n hex(sha256(payload))
  2. string to sign     = AWS4-HMAC-SHA256 \n timestamp \n scope \n
                          hex(sha256(canonical request))
  3. signing key        = HMAC-chain(AWS4+secret, date, region, service,
                          "aws4_request")
  4. signature          = hex(HMAC(signing key, string to sign))
"""

from __future__ import annotations

import hashlib
import hmac
import urllib.parse
from typing import Dict, Optional, Tuple

ALGORITHM = "AWS4-HMAC-SHA256"


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def derive_signing_key(secret_key: str, date: str, region: str,
                       service: str) -> bytes:
    """kSigning = HMAC(HMAC(HMAC(HMAC("AWS4"+secret, date), region),
    service), "aws4_request"). `date` is YYYYMMDD."""
    k_date = _hmac(("AWS4" + secret_key).encode(), date)
    k_region = _hmac(k_date, region)
    k_service = _hmac(k_region, service)
    return _hmac(k_service, "aws4_request")


def canonical_query(params: Dict[str, str]) -> str:
    """URI-encode each pair (RFC 3986, space as %20) and sort by key."""
    pairs = sorted(
        (urllib.parse.quote(k, safe="-_.~"), urllib.parse.quote(v, safe="-_.~"))
        for k, v in params.items()
    )
    return "&".join(f"{k}={v}" for k, v in pairs)


def canonical_request(
    method: str,
    path: str,
    query: str,
    headers: Dict[str, str],
    payload_hash: str,
) -> Tuple[str, str]:
    """Returns (canonical_request, signed_headers). Header names are
    lowercased and sorted; values trimmed of surrounding whitespace."""
    items = sorted((k.lower().strip(), v.strip()) for k, v in headers.items())
    canon_headers = "".join(f"{k}:{v}\n" for k, v in items)
    signed = ";".join(k for k, _ in items)
    req = "\n".join([
        method.upper(), path or "/", query, canon_headers, signed, payload_hash,
    ])
    return req, signed


def string_to_sign(amz_date: str, scope: str, canon_request: str) -> str:
    return "\n".join([
        ALGORITHM, amz_date, scope, sha256_hex(canon_request.encode()),
    ])


def sign(
    method: str,
    host: str,
    path: str,
    query_params: Dict[str, str],
    headers: Dict[str, str],
    payload: bytes,
    access_key: str,
    secret_key: str,
    region: str,
    service: str,
    amz_date: str,                      # YYYYMMDDTHHMMSSZ
    session_token: Optional[str] = None,
) -> Dict[str, str]:
    """Sign a request; returns the full header dict to send (input headers
    plus host, x-amz-date, optional x-amz-security-token, authorization)."""
    date = amz_date[:8]
    all_headers = {**headers, "host": host, "x-amz-date": amz_date}
    if session_token:
        all_headers["x-amz-security-token"] = session_token
    payload_hash = sha256_hex(payload)
    query = canonical_query(query_params)
    canon, signed = canonical_request(method, path, query, all_headers,
                                      payload_hash)
    scope = f"{date}/{region}/{service}/aws4_request"
    sts = string_to_sign(amz_date, scope, canon)
    key = derive_signing_key(secret_key, date, region, service)
    signature = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
    all_headers["authorization"] = (
        f"{ALGORITHM} Credential={access_key}/{scope}, "
        f"SignedHeaders={signed}, Signature={signature}")
    return all_headers
