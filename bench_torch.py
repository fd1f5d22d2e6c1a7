#!/usr/bin/env python
"""The port's 4K throughput bench (`webrender_tpu_torch/bench.py`): bench.py's
run on the card, printing one JSON line.  Run from the repository root:

    python bench_torch.py          # on the card
    python bench_torch.py --cpu    # on the CPU (the kernel's plain version)
"""
import sys

from webrender_tpu_torch.bench import main

if __name__ == "__main__":
    sys.exit(main())
