"""Real AWS SQS client, stdlib-only.

The port's copy of ``kube_sqs_autoscaler_tpu/metrics/sqs_aws.py``: the
worker binary's queue client for ``--sqs-queue-url``.

Reference counterpart: ``NewSqsClient`` + the AWS SDK (``sqs/sqs.go:35-43``).
The reference leans on aws-sdk-go for transport, signing, and credential
resolution; this rebuild implements the same three pieces directly:

- **Protocol**: the SQS JSON protocol (what current AWS SDKs speak) — one
  POST to the queue's endpoint with ``X-Amz-Target:
  AmazonSQS.GetQueueAttributes`` and a JSON body.  Production only ever
  needs ``GetQueueAttributes`` (``sqs/sqs.go:51``); the write-side
  ``SetQueueAttributes`` of the reference's ``SQS`` interface is a test-only
  seam (``sqs/sqs.go:16``) and lives on :class:`~.fake.FakeQueueService`.
- **Signing**: SigV4 via :mod:`..utils.sigv4`.
- **Credentials**: the standard AWS chain, same order the SDK uses
  (``sqs/sqs.go:36`` note in SURVEY §2.2-C3): env vars → shared credentials
  file (``~/.aws/credentials``, honoring ``AWS_PROFILE``) → EC2/ECS instance
  role (IMDSv2), matching how the reference runs under an instance role in
  the README deployment.

Region resolution: the ``--aws-region`` flag, else ``AWS_REGION`` /
``AWS_DEFAULT_REGION``, else parsed from the queue URL host
(``sqs.<region>.amazonaws.com``).
"""

from __future__ import annotations

import configparser
import json
import os
import time
import urllib.error
import urllib.parse
import urllib.request
from pathlib import Path
from typing import Mapping, Sequence

from ..utils.sigv4 import Credentials, SignableRequest, sign_request


class AwsError(RuntimeError):
    """Transport or service failure talking to SQS."""


class CredentialsError(AwsError):
    """No credentials found anywhere in the chain."""


# --- credential chain -------------------------------------------------------


def _credentials_from_env() -> Credentials | None:
    access_key = os.environ.get("AWS_ACCESS_KEY_ID")
    secret = os.environ.get("AWS_SECRET_ACCESS_KEY")
    if access_key and secret:
        return Credentials(access_key, secret, os.environ.get("AWS_SESSION_TOKEN"))
    return None


def _credentials_from_shared_file() -> Credentials | None:
    path = Path(
        os.environ.get("AWS_SHARED_CREDENTIALS_FILE", "~/.aws/credentials")
    ).expanduser()
    if not path.is_file():
        return None
    profile = os.environ.get("AWS_PROFILE", "default")
    parser = configparser.ConfigParser()
    try:
        parser.read(path)
    except configparser.Error:
        return None
    if profile not in parser:
        return None
    section = parser[profile]
    access_key = section.get("aws_access_key_id")
    secret = section.get("aws_secret_access_key")
    if access_key and secret:
        return Credentials(access_key, secret, section.get("aws_session_token"))
    return None


def _credentials_from_instance_role(timeout: float = 2.0) -> Credentials | None:
    """EC2 IMDSv2 instance-role credentials (how the README deployment runs)."""
    base = "http://169.254.169.254"
    try:
        token_req = urllib.request.Request(
            f"{base}/latest/api/token",
            method="PUT",
            headers={"X-aws-ec2-metadata-token-ttl-seconds": "21600"},
        )
        with urllib.request.urlopen(token_req, timeout=timeout) as resp:
            imds_token = resp.read().decode()
        headers = {"X-aws-ec2-metadata-token": imds_token}
        role_url = f"{base}/latest/meta-data/iam/security-credentials/"
        with urllib.request.urlopen(
            urllib.request.Request(role_url, headers=headers), timeout=timeout
        ) as resp:
            role = resp.read().decode().strip().splitlines()[0]
        with urllib.request.urlopen(
            urllib.request.Request(role_url + role, headers=headers), timeout=timeout
        ) as resp:
            data = json.loads(resp.read())
        expires_at = None
        if data.get("Expiration"):
            try:
                expires_at = time.mktime(
                    time.strptime(data["Expiration"], "%Y-%m-%dT%H:%M:%SZ")
                ) - time.timezone
            except ValueError:
                pass
        return Credentials(
            data["AccessKeyId"],
            data["SecretAccessKey"],
            data.get("Token"),
            expires_at=expires_at,
        )
    except Exception:
        return None


def resolve_credentials(allow_imds: bool = True) -> Credentials:
    """Standard chain: env -> shared file -> instance role."""
    for provider in (_credentials_from_env, _credentials_from_shared_file):
        creds = provider()
        if creds:
            return creds
    if allow_imds:
        creds = _credentials_from_instance_role()
        if creds:
            return creds
    raise CredentialsError(
        "No AWS credentials found (env, shared credentials file, instance role)"
    )


def region_from_queue_url(queue_url: str) -> str | None:
    """``https://sqs.us-east-1.amazonaws.com/123/q`` -> ``us-east-1``."""
    host = urllib.parse.urlsplit(queue_url).netloc
    parts = host.split(".")
    if len(parts) >= 3 and parts[0] == "sqs":
        return parts[1]
    return None


# --- the client -------------------------------------------------------------


class AwsSqsService:
    """``QueueService`` implementation against real AWS SQS."""

    # refresh temporary credentials this many seconds before they expire
    CREDENTIAL_REFRESH_WINDOW = 300.0

    def __init__(
        self,
        region: str = "",
        credentials: Credentials | None = None,
        timeout: float = 10.0,
        endpoint: str | None = None,
    ) -> None:
        self.region = region
        self._credentials = credentials
        # Explicitly injected credentials are the caller's responsibility;
        # chain-resolved ones are refreshed as they near expiry (the SDK the
        # reference uses does the same for instance-role credentials).
        self._credentials_injected = credentials is not None
        self.timeout = timeout
        self.endpoint = endpoint  # override for tests / localstack-style use

    def _current_credentials(self) -> Credentials:
        creds = self._credentials
        stale = (
            creds is None
            or (
                not self._credentials_injected
                and creds.expires_at is not None
                and time.time() > creds.expires_at - self.CREDENTIAL_REFRESH_WINDOW
            )
        )
        if stale:
            creds = self._credentials = resolve_credentials()
        return creds

    def _resolve_region(self, queue_url: str) -> str:
        if self.region:
            return self.region
        env_region = os.environ.get("AWS_REGION") or os.environ.get(
            "AWS_DEFAULT_REGION"
        )
        if env_region:
            return env_region
        from_url = region_from_queue_url(queue_url)
        if from_url:
            return from_url
        raise AwsError(
            "Cannot determine AWS region: pass --aws-region, set AWS_REGION, "
            "or use a regional queue URL"
        )

    def _call(self, action: str, queue_url: str, body: dict) -> dict:
        """One signed SQS JSON-protocol call (``X-Amz-Target`` dispatch)."""
        region = self._resolve_region(queue_url)
        credentials = self._current_credentials()

        parsed = urllib.parse.urlsplit(self.endpoint or queue_url)
        url = urllib.parse.urlunsplit((parsed.scheme, parsed.netloc, "/", "", ""))
        request = SignableRequest(
            method="POST",
            url=url,
            headers={
                "Content-Type": "application/x-amz-json-1.0",
                "X-Amz-Target": f"AmazonSQS.{action}",
            },
            body=json.dumps(body).encode("utf-8"),
        )
        amz_date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
        signed = sign_request(request, credentials, region, "sqs", amz_date)

        http_request = urllib.request.Request(
            signed.url, data=signed.body, headers=signed.headers, method="POST"
        )
        try:
            with urllib.request.urlopen(http_request, timeout=self.timeout) as resp:
                raw = resp.read()
                return json.loads(raw) if raw.strip() else {}
        except urllib.error.HTTPError as err:
            detail = err.read().decode("utf-8", "replace")[:512]
            raise AwsError(f"SQS returned HTTP {err.code}: {detail}") from err
        except urllib.error.URLError as err:
            raise AwsError(f"SQS request failed: {err.reason}") from err

    def get_queue_attributes(
        self, queue_url: str, attribute_names: Sequence[str]
    ) -> Mapping[str, str]:
        payload = self._call(
            "GetQueueAttributes",
            queue_url,
            {"QueueUrl": queue_url, "AttributeNames": list(attribute_names)},
        )
        return payload.get("Attributes", {})

    # --- message operations (used by the scaled workers, not the
    # controller; the reference's controller likewise only ever reads
    # attributes, sqs/sqs.go:51) ---------------------------------------

    def send_message(self, queue_url: str, body: str) -> str:
        payload = self._call(
            "SendMessage", queue_url, {"QueueUrl": queue_url, "MessageBody": body}
        )
        return payload.get("MessageId", "")

    def receive_messages(
        self, queue_url: str, max_messages: int = 1, wait_time_s: int = 0
    ) -> list[dict]:
        payload = self._call(
            "ReceiveMessage",
            queue_url,
            {
                "QueueUrl": queue_url,
                # SQS rejects MaxNumberOfMessages outside 1..10
                "MaxNumberOfMessages": max(1, min(max_messages, 10)),
                "WaitTimeSeconds": wait_time_s,
                # SentTimestamp feeds the workers' --request-ttl
                # admission deadline; without it messages never expire
                "AttributeNames": ["SentTimestamp"],
            },
        )
        out = []
        for m in payload.get("Messages", []):
            message = {"MessageId": m.get("MessageId", ""),
                       "ReceiptHandle": m["ReceiptHandle"],
                       "Body": m.get("Body", "")}
            if m.get("Attributes"):
                message["Attributes"] = m["Attributes"]
            out.append(message)
        return out

    def delete_message(self, queue_url: str, receipt_handle: str) -> None:
        self._call(
            "DeleteMessage",
            queue_url,
            {"QueueUrl": queue_url, "ReceiptHandle": receipt_handle},
        )

    def change_message_visibility(
        self, queue_url: str, receipt_handle: str, visibility_timeout: float
    ) -> None:
        """Reset an in-flight message's visibility window (0 = return it
        to the queue immediately — the fleet's drain-timeout and
        evacuation hand-back path)."""
        self._call(
            "ChangeMessageVisibility",
            queue_url,
            {"QueueUrl": queue_url, "ReceiptHandle": receipt_handle,
             "VisibilityTimeout": int(visibility_timeout)},
        )
