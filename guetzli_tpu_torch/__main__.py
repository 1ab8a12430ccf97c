"""python -m guetzli_tpu_torch: the encoder's command line (cli.py)."""

import sys

from guetzli_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
