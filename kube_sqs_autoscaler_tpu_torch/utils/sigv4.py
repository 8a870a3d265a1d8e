"""AWS Signature Version 4 request signing, stdlib-only.

The port's copy of ``kube_sqs_autoscaler_tpu/utils/sigv4.py``.

The reference gets signing for free from aws-sdk-go (``sqs/sqs.go:36``);
this rebuild has a no-third-party-dependency constraint, so SigV4 is
implemented directly per the public specification
(docs.aws.amazon.com/IAM/latest/UserGuide/create-signed-request.html).

Pure functions over explicit inputs (timestamp included) so signatures are
deterministic and testable against golden vectors.
"""

from __future__ import annotations

import hashlib
import hmac
import urllib.parse
from dataclasses import dataclass, field


@dataclass(frozen=True)
class Credentials:
    """A resolved AWS credential set (static or temporary).

    ``expires_at`` (epoch seconds) is set for temporary credentials from the
    instance-metadata service so callers can refresh before expiry; static
    env/file credentials leave it ``None``.
    """

    access_key_id: str
    secret_access_key: str
    session_token: str | None = None
    expires_at: float | None = None


@dataclass
class SignableRequest:
    """The parts of an HTTP request SigV4 covers."""

    method: str
    url: str  # absolute URL; query string (if any) must be RFC3986-encoded
    headers: dict[str, str] = field(default_factory=dict)
    body: bytes = b""


def _hmac_sha256(key: bytes, message: str) -> bytes:
    return hmac.new(key, message.encode("utf-8"), hashlib.sha256).digest()


def _sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _canonical_uri(path: str) -> str:
    # single URI-encode of each path segment, preserving slashes; empty -> "/"
    if not path:
        return "/"
    return urllib.parse.quote(path, safe="/-_.~")


def _canonical_query(query: str) -> str:
    # Decode percent-escapes then strictly re-encode per SigV4. Split
    # manually rather than via parse_qsl: in an RFC3986 query "+" is a
    # literal plus, and parse_qsl would corrupt it to a space.
    if not query:
        return ""
    encoded = []
    for pair in query.split("&"):
        key, _, value = pair.partition("=")
        encoded.append(
            (
                urllib.parse.quote(urllib.parse.unquote(key), safe="-_.~"),
                urllib.parse.quote(urllib.parse.unquote(value), safe="-_.~"),
            )
        )
    return "&".join(f"{k}={v}" for k, v in sorted(encoded))


def sign_request(
    request: SignableRequest,
    credentials: Credentials,
    region: str,
    service: str,
    amz_date: str,
) -> SignableRequest:
    """Return ``request`` with SigV4 ``Authorization`` (and aux) headers added.

    ``amz_date`` is the ISO-basic UTC timestamp, e.g. ``"20260729T120000Z"``;
    callers pass ``time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())``.
    """
    parsed = urllib.parse.urlsplit(request.url)
    date_stamp = amz_date[:8]
    payload_hash = _sha256_hex(request.body)

    headers = dict(request.headers)
    headers["host"] = parsed.netloc
    headers["x-amz-date"] = amz_date
    if credentials.session_token:
        headers["x-amz-security-token"] = credentials.session_token

    lower = {k.lower(): " ".join(str(v).split()) for k, v in headers.items()}
    signed_header_names = ";".join(sorted(lower))
    canonical_headers = "".join(f"{k}:{lower[k]}\n" for k in sorted(lower))

    canonical_request = "\n".join(
        [
            request.method.upper(),
            _canonical_uri(parsed.path),
            _canonical_query(parsed.query),
            canonical_headers,
            signed_header_names,
            payload_hash,
        ]
    )

    scope = f"{date_stamp}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join(
        [
            "AWS4-HMAC-SHA256",
            amz_date,
            scope,
            _sha256_hex(canonical_request.encode("utf-8")),
        ]
    )

    key = _hmac_sha256(
        _hmac_sha256(
            _hmac_sha256(
                _hmac_sha256(
                    ("AWS4" + credentials.secret_access_key).encode("utf-8"),
                    date_stamp,
                ),
                region,
            ),
            service,
        ),
        "aws4_request",
    )
    signature = hmac.new(
        key, string_to_sign.encode("utf-8"), hashlib.sha256
    ).hexdigest()

    headers["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={credentials.access_key_id}/{scope}, "
        f"SignedHeaders={signed_header_names}, Signature={signature}"
    )
    return SignableRequest(
        method=request.method, url=request.url, headers=headers, body=request.body
    )
