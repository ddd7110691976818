"""`python -m ray_tracing_in_one_weekend_tpu_torch` — render to stdout as PPM
(the reference's `./main > out.ppm` contract)."""

import sys

from ray_tracing_in_one_weekend_tpu_torch.utils.cli import main

sys.exit(main())
