"""Run `dryrun_multichip` on the devices named on the command line:

    python -m lives_tpu_torch.parallel cuda:0 cuda:1 cuda:2 cuda:3
"""

import sys

from .dryrun import dryrun_multichip

if len(sys.argv) < 2:
    sys.exit("usage: python -m lives_tpu_torch.parallel DEVICE...")
dryrun_multichip(sys.argv[1:])
print(f"dryrun_multichip: ok on {sys.argv[1:]}")
