"""``python -m kaminpar_tpu_torch`` — the KaMinPar binary equivalent."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
