import sys

from tpulbm_torch.cli import main

sys.exit(main())
