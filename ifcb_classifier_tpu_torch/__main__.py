"""`python -m ifcb_classifier_tpu_torch TRAIN|RUN ...` — the reference's
`python neuston_net.py ...` entry point, on the GPU."""
from .cli import main_cli

main_cli()
