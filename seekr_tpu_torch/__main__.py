"""``python -m seekr_tpu_torch <command> [args]``: the port's command line."""

import sys

from seekr_tpu_torch.cli import main

sys.exit(main())
