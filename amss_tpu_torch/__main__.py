"""``python -m amss_tpu_torch`` is ``python -m amss_tpu_torch.cli`` (and the
``amss-tpu-torch`` script)."""

from amss_tpu_torch.cli import main

if __name__ == "__main__":
    main()
