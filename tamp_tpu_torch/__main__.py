"""``python -m tamp_tpu_torch``: the command-line interface (cli/main.py)."""

from tamp_tpu_torch.cli.main import run_app

if __name__ == "__main__":
    run_app()
