"""``python -m spatial_alignment_tpu_torch``: the command line (:mod:`.cli`)."""

from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
