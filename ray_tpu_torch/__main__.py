"""``python -m ray_tpu_torch`` — the CLI entry point (reference: the `ray` CLI,
python/ray/scripts/scripts.py)."""

from ray_tpu_torch.scripts.cli import main

if __name__ == "__main__":  # importing the package's modules runs no command
    main()
