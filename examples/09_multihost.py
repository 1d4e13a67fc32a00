"""Multi-host-shaped scaling: sources sharded across PROCESSES.

Sources are embarrassingly parallel, so the same mesh story that shards
them over one host's chips (example 04) extends across hosts: a 2-D
('host', 'chip') mesh where the source axis crosses the process boundary
and the only collective — the mixdown psum — rides the inter-host link.

This example runs the executable local validation: 2 coordinated
processes x 2 virtual CPU devices via ``jax.distributed``, one full
batched render step, the cross-process mixdown checked against an
unsharded render (the same stage __graft_entry__'s dryrun runs at 2x4).

On REAL multi-host GPUs, the per-process worker is the template — run on
each host:

    python -m jefferson_tpu.parallel.multihost \
        --process-id $RANK --num-processes $K --coordinator host0:PORT

(no --local-devices override: each host contributes its own devices).
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # repo-root import

from jefferson_tpu.parallel.multihost import run_multiprocess_dryrun

if __name__ == "__main__":
    run_multiprocess_dryrun(num_processes=2, local_devices=2)
    print("multi-process mesh render verified (see [multihost] line above)")
