"""``python -m tpualign_torch``: the port's command line (:mod:`tpualign_torch.cli`)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
