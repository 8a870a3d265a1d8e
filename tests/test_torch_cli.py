"""The port's controller binary, held against the JAX package's.

- ``build_parser()``: every reference flag with its name, default,
  choices and parsed value; the same usage errors with exit 2;
- ``--policy predictive|learned``: the reference's checks and messages
  (``tests/test_torch_controller_e2e.py`` runs both policies end to end);
- ``config_from_args``, ``resilience_from_args`` and the journal header
  meta equal the reference's;
- Go durations parse as the reference parses them;
- ``python -m kube_sqs_autoscaler_tpu_torch --help`` lists every flag;
- ``main()`` wires the real clients, the resilience layer, the durable
  store, the journal and the metrics server, and stops on SIGTERM.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from kube_sqs_autoscaler_tpu import cli as ref_cli
from kube_sqs_autoscaler_tpu.utils import duration as ref_duration
from kube_sqs_autoscaler_tpu_torch import cli
from kube_sqs_autoscaler_tpu_torch.utils import duration

ROOT = Path(__file__).resolve().parents[1]


def actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


REF_ACTIONS = actions(ref_cli.build_parser())
PORT_ACTIONS = actions(cli.build_parser())

# a legal value of each flag, to check both parsers read it alike
SAMPLES = {
    "poll_period": "1m30s", "scale_down_cool_down": "45s",
    "scale_up_cool_down": "2m", "scale_up_messages": "7",
    "scale_down_messages": "2", "scale_up_pods": "3", "scale_down_pods": "2",
    "max_pods": "9", "min_pods": "2", "aws_region": "eu-west-1",
    "attribute_names": "ApproximateNumberOfMessages",
    "sqs_queue_url": "https://sqs.eu-west-1.amazonaws.com/1/q",
    "kubernetes_deployment": "workers", "kubernetes_namespace": "prod",
    "metrics_port": "9090", "journal_path": "/tmp/j.jsonl",
    "journal_ring": "32", "journal_max_bytes": "8192", "request_trace": "0",
    "policy": "reactive", "policy_checkpoint": "ck.json",
    "forecaster": "ewma", "forecast_horizon": "90s",
    "forecast_history": "64", "metric_retries": "2",
    "metric_timeout": "500ms", "scaler_retries": "1",
    "scaler_timeout": "1.5s", "breaker_failures": "3",
    "breaker_reset": "20s", "stale_depth_ttl": "1m",
    "healthz_stale_after": "20s", "state_path": "/tmp/s.json",
    "state_max_age": "1h",
}


def test_the_port_has_every_reference_flag():
    # and --device, the port's counterpart of the reference's
    # JAX_PLATFORMS: where the predictive and learned policies compute
    assert list(PORT_ACTIONS) == [*REF_ACTIONS, "device"]
    assert PORT_ACTIONS["device"].default == "cuda"
    assert set(SAMPLES) == set(REF_ACTIONS)
    assert len(REF_ACTIONS) == 34


@pytest.mark.parametrize("dest", list(REF_ACTIONS))
def test_flag_matches_reference(dest):
    ref, port = REF_ACTIONS[dest], PORT_ACTIONS[dest]
    assert port.option_strings == ref.option_strings
    assert port.default == ref.default
    assert port.choices == ref.choices
    assert port.nargs == ref.nargs
    assert port.metavar == ref.metavar
    flag = ref.option_strings[0]
    got = [p.parse_args([f"{flag}={SAMPLES[dest]}"]) for p in (
        ref_cli.build_parser(), cli.build_parser())]
    assert getattr(got[1], dest) == getattr(got[0], dest)


USAGE_ERRORS = [
    ["--poll-period=10"],
    ["--poll-period=5x"],
    ["--max-pods=many"],
    ["--metric-retries=-1"],
    ["--scaler-retries=-2"],
    ["--forecast-history=1"],
    ["--policy=quantum"],
    ["--forecaster=arima"],
    ["--healthz-stale-after=5s", "--poll-period=5s"],
    ["--state-max-age=1m"],
    ["--policy-checkpoint=ck.json"],
    ["--no-such-flag"],
]


def usage_error(parser, argv, capsys, check=None):
    with pytest.raises(SystemExit) as info:
        args = parser.parse_args(argv)
        (check or ref_cli.validate_flag_interactions)(parser, args)
    message = capsys.readouterr().err.strip().splitlines()[-1]
    return info.value.code, message.split(" error: ", 1)[1]


@pytest.mark.parametrize("argv", USAGE_ERRORS, ids=lambda a: " ".join(a))
def test_usage_errors_match_reference(argv, capsys):
    ref = usage_error(ref_cli.build_parser(), argv, capsys)
    port = usage_error(cli.build_parser(), argv, capsys,
                       cli.validate_flag_interactions)
    assert port == ref and port[0] == 2


@pytest.mark.parametrize("argv,item", [
    (["--policy=predictive"], None),
    (["--policy=learned"], "requires --policy-checkpoint"),
    (["--policy=learned", "--policy-checkpoint=ck.json"], "does not exist"),
    (["--request-trace=1"], None),
    (["--request-trace=x"], "invalid int value"),
])
def test_unported_flags_exit_naming_their_item(argv, item, capsys):
    """Every reference flag is ported: ``--policy predictive`` and
    ``--request-trace`` are accepted and parse as the reference's do;
    ``--policy learned`` without a checkpoint, or with one that does not
    exist, and a ``--request-trace`` that is not an integer, exit 2 with
    the reference binary's message."""
    if item is None:
        parser = cli.build_parser()
        args = parser.parse_args(argv)
        cli.validate_flag_interactions(parser, args)
        assert cli.load_learned_checkpoint(parser, args) is None
        ref = vars(ref_cli.build_parser().parse_args(argv))
        assert {k: v for k, v in vars(args).items() if k != "device"} == ref
        return
    errors = []
    for main in (ref_cli.main, cli.main):
        with pytest.raises(SystemExit) as info:
            main(argv)
        assert info.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert item in errors[1]
    assert errors[1].split(" error: ", 1)[1] == errors[0].split(
        " error: ", 1)[1]


ARGV = ["--poll-period=2s", "--scale-up-cool-down=4s",
        "--scale-down-cool-down=8s", "--scale-up-messages=50",
        "--scale-down-messages=5", "--max-pods=7", "--min-pods=2",
        "--metric-retries=2", "--scaler-timeout=1s", "--breaker-failures=3",
        "--stale-depth-ttl=30s", "--kubernetes-deployment=w",
        "--sqs-queue-url=https://sqs.x/q"]


LEARNED = ["--policy=learned",
           f"--policy-checkpoint={ROOT / 'LEARNED_POLICY.json'}"]


@pytest.mark.parametrize("argv", [
    [], ARGV, ["--policy=predictive", "--forecaster=lstsq",
               "--forecast-horizon=90s", "--forecast-history=32"], LEARNED,
], ids=["defaults", "set", "predictive", "learned"])
def test_configs_and_journal_meta_match_reference(argv):
    ref_args = ref_cli.build_parser().parse_args(argv)
    args = cli.build_parser().parse_args([*argv, "--device", "cpu"])
    assert {k: v for k, v in vars(args).items() if k != "device"} == \
        vars(ref_args)
    if argv is LEARNED:
        # the learned policy's meta names the checkpoint's hash and its
        # feature window, the reference's
        ref_ck = ref_cli.load_learned_checkpoint(ref_cli.build_parser(),
                                                 ref_args)
        ck = cli.load_learned_checkpoint(cli.build_parser(), args)
        assert cli._journal_meta(args, ck) == ref_cli._journal_meta(
            ref_args, ref_ck)
        return
    ref_config, config = ref_cli.config_from_args(ref_args), \
        cli.config_from_args(args)
    assert config.poll_interval == ref_config.poll_interval
    assert vars(config.policy) == vars(ref_config.policy)
    assert vars(cli.resilience_from_args(args)) == vars(
        ref_cli.resilience_from_args(ref_args))
    assert cli._journal_meta(args) == ref_cli._journal_meta(ref_args)


DURATIONS = ["5s", "300ms", "-1.5h", "2h45m", "1m30s", "0", "+10s", "1.5us",
             "2µs", "3ns", ".5s", "1h0m0.5s"]
BAD_DURATIONS = ["10", "", "s", "1.2.3s", "5 s", "-", "1d", "1..s"]


@pytest.mark.parametrize("text", DURATIONS + BAD_DURATIONS)
def test_durations_parse_as_the_reference(text):
    def parse(module):
        try:
            return module.parse_duration(text)
        except module.DurationError as err:
            return ("error", str(err))

    assert parse(duration) == parse(ref_duration)
    if text in DURATIONS:
        seconds = duration.parse_duration(text)
        assert duration.format_duration(seconds) == \
            ref_duration.format_duration(seconds)


def test_module_help_lists_every_flag():
    out = subprocess.run(
        [sys.executable, "-m", "kube_sqs_autoscaler_tpu_torch", "--help"],
        capture_output=True, text=True, timeout=60, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    for action in REF_ACTIONS.values():
        assert action.option_strings[0] in out.stdout


class _FakeSqs:
    def __init__(self, region=""):
        self.region = region

    def get_queue_attributes(self, queue_url, names):
        return {"ApproximateNumberOfMessages": "500",
                "ApproximateNumberOfMessagesDelayed": "0",
                "ApproximateNumberOfMessagesNotVisible": "0"}


def test_main_wires_the_controller(tmp_path, monkeypatch):
    """``main()`` against in-memory clients: one tick with the durable
    store, the journal, the metrics server and the resilience layer, then
    the stop a SIGTERM asks for."""
    from kube_sqs_autoscaler_tpu_torch.core import loop as loop_module
    from kube_sqs_autoscaler_tpu_torch.metrics import sqs_aws
    from kube_sqs_autoscaler_tpu_torch.obs.journal import (
        read_journal_episodes,
    )
    from kube_sqs_autoscaler_tpu_torch.scale import kube
    from kube_sqs_autoscaler_tpu_torch.scale.fake import FakeDeploymentAPI

    api = FakeDeploymentAPI.with_deployments("prod", 2, "w")
    monkeypatch.setattr(kube, "KubeDeploymentAPI", lambda namespace: api)
    monkeypatch.setattr(sqs_aws, "AwsSqsService", _FakeSqs)
    handlers = {}
    monkeypatch.setattr(cli.signal, "signal",
                        lambda sig, fn: handlers.__setitem__(sig, fn))
    real_tick = loop_module.ControlLoop.tick
    seen = []

    def tick(self, state):
        state = real_tick(self, state)
        seen.append(self)
        handlers[cli.signal.SIGTERM](cli.signal.SIGTERM, None)
        return state

    monkeypatch.setattr(loop_module.ControlLoop, "tick", tick)
    monkeypatch.setattr(loop_module.SystemClock, "sleep",
                        lambda self, s: None)
    journal, state = tmp_path / "j.jsonl", tmp_path / "s.json"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cli.main(["--kubernetes-deployment=w", "--kubernetes-namespace=prod",
              "--sqs-queue-url=q", "--scale-up-cool-down=0s",
              f"--metrics-port={port}", "--journal-path", str(journal),
              "--state-path", str(state), "--breaker-failures=2"])
    loop = seen[0]
    assert loop.resilience is not None and loop.durable is not None
    assert api.replicas("w") == 3  # 500 >= 100 fired the up gate
    episodes = read_journal_episodes(str(journal))
    assert len(episodes) == 1 and len(episodes[0][1]) == 1
    assert episodes[0][0]["resilience"]["breaker_failures"] == 2
    assert episodes[0][1][0].breaker_state == "closed"
    assert state.exists() and "resilience" in state.read_text()
    assert sorted(handlers) == sorted([cli.signal.SIGTERM,
                                       cli.signal.SIGINT])


def test_main_without_kube_config_panics_with_the_reference_message(
        monkeypatch):
    from kube_sqs_autoscaler_tpu_torch.scale.kube import KubeConfigError

    monkeypatch.setenv("KUBE_CONFIG_PATH", "/does/not/exist")
    with pytest.raises(KubeConfigError,
                       match="Failed to configure incluster or local config"):
        cli.main([])


def test_parser_types_reject_like_the_reference():
    for parser in (ref_cli.build_parser(), cli.build_parser()):
        with pytest.raises(SystemExit):
            parser.parse_args(["--journal-ring=x"])
    assert cli._retry_count("3") == 3
    with pytest.raises(argparse.ArgumentTypeError):
        cli._history_size("1")
    assert os.path.exists(ROOT / "kube_sqs_autoscaler_tpu_torch" /
                          "__main__.py")
