import sys

from clraytracer_tpu_torch.cli import main

sys.exit(main())
