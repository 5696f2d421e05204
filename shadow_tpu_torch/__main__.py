"""`python -m shadow_tpu_torch CONFIG`: the port's CLI (`cli.main`)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
