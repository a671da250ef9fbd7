import sys

from bsyolo_tpu_torch.cli import main

sys.exit(main())
