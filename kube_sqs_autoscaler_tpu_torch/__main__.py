"""``python -m kube_sqs_autoscaler_tpu_torch`` — the controller binary
(:func:`.cli.main`)."""

from .cli import main

main()
