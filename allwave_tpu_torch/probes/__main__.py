"""python -m allwave_tpu_torch.probes [--only kexp6,kexp8,...] [--device cpu]"""

import sys

from .runner import main

if __name__ == "__main__":
    sys.exit(main())
