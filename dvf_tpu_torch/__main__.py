"""``python -m dvf_tpu_torch``: the command line (:mod:`dvf_tpu_torch.cli`).

Guarded, so importing this module (as a walk over the package does)
runs nothing."""

from dvf_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
