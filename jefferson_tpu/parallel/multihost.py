"""Multi-process (multi-host-shaped) mesh validation.

The reference is strictly single-GPU (SURVEY §2 parallelism map); the
rebuild's own scaling claim is that independent sources shard over any mesh
with the mixdown psum as the only collective — including a 2-D
('host', 'chip') factorization where the source axis crosses a process
(DCN-shaped) boundary.  This module makes that claim executable WITHOUT
multi-host hardware: ``run_multiprocess_dryrun`` spawns N coordinated
processes (``jax.distributed.initialize`` over a local coordinator, Gloo
collectives), each holding ``local_devices`` virtual CPU devices, builds
the global ('host', 'chip') mesh, and runs ONE full batched render step
with

  * sources sharded over BOTH mesh axes (host-major),
  * the mixdown replicated — GSPMD inserts the cross-process psum,
  * process 0 checking the mixed output against an unsharded single-device
    render of the same inputs (exact same chunk function).

The per-process worker is this module's ``__main__`` (see _worker).  The
same worker doubles as the template for a REAL multi-host launch: on k
GPU hosts, run ``python -m jefferson_tpu.parallel.multihost --process-id
$RANK --num-processes $K --coordinator host0:PORT`` with no
``--local-devices`` override and the host's devices form the 'chip' axis.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_multiprocess_dryrun(
    num_processes: int = 2, local_devices: int = 4, timeout: float = 600.0
) -> None:
    """Spawn the coordinated worker processes and raise if any fails.

    The coordinator port is picked free-then-released (unavoidable TOCTOU:
    jax's coordinator binds it seconds later inside process 0), so a lost
    race to an unrelated service is retried ONCE on a fresh port instead of
    surfacing as an opaque full-timeout failure."""
    try:
        _run_once(num_processes, local_devices, timeout)
    except RuntimeError as e:
        if "timeout" not in str(e):
            raise
        _run_once(num_processes, local_devices, timeout)


def _run_once(num_processes: int, local_devices: int, timeout: float) -> None:
    from .mesh import xla_flags_with_device_count

    port = _free_port()
    env = dict(os.environ)
    # children force the CPU platform themselves; the count flag is
    # REPLACED so --local-devices rules even over
    # an inherited different count (shared helper — see mesh.py)
    env["XLA_FLAGS"] = xla_flags_with_device_count(
        env.get("XLA_FLAGS", ""), local_devices
    )
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONUNBUFFERED"] = "1"  # a SIGKILLed worker's log must be complete
    # the package is repo-rooted, not pip-installed: `-m jefferson_tpu...`
    # in the children needs the repo root on PYTHONPATH regardless of the
    # caller's cwd (round-5 review: reproduced failure from examples/).
    # NOTE: no trailing empty entry when PYTHONPATH is unset — an empty
    # element means "cwd", re-adding the very cwd-dependence this fixes.
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    existing = env.get("PYTHONPATH", "")
    env["PYTHONPATH"] = repo + (os.pathsep + existing if existing else "")
    # stdout goes to unbuffered temp FILES, not pipes: a child emitting a
    # large traceback can never block on a full pipe, and the parent can
    # poll ALL children against one shared deadline instead of waiting on
    # them sequentially (one dead worker used to stall the dryrun for the
    # full per-child timeout before the next child was even looked at).
    # Binary mode: a killed worker can end its stream mid-UTF-8 sequence,
    # and a text-mode read() raising UnicodeDecodeError would mask the
    # real failure.
    logs = [tempfile.TemporaryFile(mode="w+b") for _ in range(num_processes)]
    procs = [
        subprocess.Popen(
            [
                sys.executable, "-m", "jefferson_tpu.parallel.multihost",
                "--process-id", str(i),
                "--num-processes", str(num_processes),
                "--local-devices", str(local_devices),
                "--coordinator", f"localhost:{port}",
            ],
            env=env,
            stdout=logs[i],
            stderr=subprocess.STDOUT,
        )
        for i in range(num_processes)
    ]
    deadline = time.monotonic() + timeout
    failed = []
    while True:
        codes = [p.poll() for p in procs]
        failed = [(i, c) for i, c in enumerate(codes) if c not in (None, 0)]
        if failed or all(c is not None for c in codes):
            break  # fail fast: a dead worker strands the rest in a collective
        if time.monotonic() > deadline:
            failed.extend(
                (i, "timeout") for i, c in enumerate(codes) if c is None
            )
            break
        time.sleep(0.25)
    for p in procs:  # reap survivors of a failure (or everything on success)
        if p.poll() is None:
            p.kill()
            p.wait()

    def read(i: int) -> str:
        logs[i].flush()
        logs[i].seek(0)
        out = logs[i].read().decode("utf-8", errors="replace")
        logs[i].close()
        return out

    outs = [read(i) for i in range(num_processes)]
    if failed:
        raise RuntimeError(
            f"multi-process dryrun failed: {failed}\n" + "\n".join(outs)
        )
    for out in outs:
        for line in out.splitlines():
            if line.startswith("[multihost"):
                print(line)


def _worker(process_id: int, num_processes: int, local_devices: int | None,
            coordinator: str) -> None:
    if local_devices:
        from .mesh import xla_flags_with_device_count

        os.environ["XLA_FLAGS"] = xla_flags_with_device_count(
            os.environ.get("XLA_FLAGS", ""), local_devices
        )
    import jax

    if local_devices:  # virtual-CPU mode (the dryrun); real hosts keep theirs
        jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from jefferson_tpu import DEFAULT_CONFIG, synthetic_database
    from jefferson_tpu.engine.batch import batched_chunk_fn, mix_sources
    from jefferson_tpu.engine.plan import make_plan
    from jefferson_tpu.trajectory.trajectory import CircularOrbit

    devs = jax.devices()
    n_local = len(jax.local_devices())
    # hard errors, not asserts: the gates must survive python -O (this
    # worker is also the real multi-host launch template)
    if len(devs) != num_processes * n_local:
        raise RuntimeError(
            f"global device count {len(devs)} != "
            f"{num_processes} processes x {n_local} local devices"
        )
    mesh = Mesh(
        np.array(devs).reshape(num_processes, n_local), ("host", "chip")
    )

    # deterministic global inputs (every process builds the same arrays)
    cfg = DEFAULT_CONFIG
    db = synthetic_database(cfg)
    s, nb = 2 * len(devs), 8
    rng = np.random.default_rng(0)
    spectra_np = (
        np.real(db.spectra).astype(np.float32),
        np.imag(db.spectra).astype(np.float32),
    )
    hists_np = np.zeros((s, cfg.history_len), np.float32)
    feds_np = (rng.standard_normal((s, nb * cfg.frames_per_buffer)) * 0.2).astype(np.float32)
    plans = [
        make_plan(CircularOrbit(period_s=0.5 + 0.1 * i, ele=5, r=1.0).sample(nb, cfg), cfg)
        for i in range(s)
    ]
    stack = lambda attr: np.stack([getattr(p, attr) for p in plans])
    rest_np = [
        feds_np,
        stack("idx_new"), stack("w_new"), stack("idx_old"), stack("w_old"),
        stack("xfade"), stack("u_hi"), stack("u_lo"), stack("inv_frac"),
    ]

    # global arrays: source axis sharded host-major over BOTH mesh axes, so
    # each process owns its contiguous s/num_processes sources
    src_axes = ("host", "chip")
    sph = s // num_processes
    lo = process_id * sph

    def gshard(a):
        spec = P(src_axes, *([None] * (a.ndim - 1)))
        return multihost_utils.host_local_array_to_global_array(
            a[lo : lo + sph], mesh, spec
        )

    def grep(a):
        return multihost_utils.host_local_array_to_global_array(a, mesh, P())

    spectra_dev = (grep(spectra_np[0]), grep(spectra_np[1]))
    hists_dev = gshard(hists_np)
    rest_dev = [gshard(a) for a in rest_np]

    step = batched_chunk_fn(cfg, num_blocks=nb, with_xfade=True)

    def full_step(spectra, hists, *xs):
        outs, new_hists = step(spectra, hists, *xs)
        return outs, mix_sources(outs), new_hists

    jitted = jax.jit(
        full_step,
        out_shardings=(
            NamedSharding(mesh, P(src_axes, None, None, None)),
            NamedSharding(mesh, P()),  # mixdown: psum crosses the host axis
            NamedSharding(mesh, P(src_axes, None)),
        ),
    )
    outs, mixed, new_hists = jitted(spectra_dev, hists_dev, *rest_dev)
    jax.block_until_ready((outs, mixed, new_hists))
    if outs.shape != (s, nb, cfg.frames_per_buffer, 2):
        raise RuntimeError(f"sharded outs shape {outs.shape}")
    if new_hists.shape != (s, cfg.history_len):
        raise RuntimeError(f"sharded new_hists shape {new_hists.shape}")
    mixed_np = np.asarray(mixed)  # replicated -> locally addressable
    if mixed_np.shape != (nb, cfg.frames_per_buffer, 2):
        raise RuntimeError(f"mixdown shape {mixed_np.shape}")
    if not np.isfinite(mixed_np).all():
        raise RuntimeError("non-finite values in the cross-process mixdown")

    # process 0: the cross-process psum must equal an unsharded single-device
    # render of the same inputs through the same chunk function
    if process_id == 0:
        with jax.default_device(jax.local_devices()[0]):
            ref_outs, _ = jax.jit(step)(
                tuple(jnp.asarray(a) for a in spectra_np),
                jnp.asarray(hists_np),
                *[jnp.asarray(a) for a in rest_np],
            )
            ref_mixed = np.asarray(mix_sources(ref_outs))
            ref_outs_np = np.asarray(ref_outs)
        d = float(np.abs(mixed_np - ref_mixed).max())
        if d >= 1e-5:
            raise RuntimeError(f"multi-process mixdown mismatch: {d}")
        # ORDER-SENSITIVE check: the mixdown sum is permutation-invariant
        # over sources, so it cannot see a source-placement bug (host-major
        # slicing / mesh reshape mis-assigning rows).  Compare this
        # process's addressable shard of the per-source outputs row-for-row
        # against the unsharded reference.
        shards = sorted(
            outs.addressable_shards, key=lambda sh: sh.index[0].start or 0
        )
        got_local = np.concatenate([np.asarray(sh.data) for sh in shards])
        d_rows = float(np.abs(got_local - ref_outs_np[lo : lo + sph]).max())
        if d_rows >= 1e-5:
            raise RuntimeError(
                f"source-placement mismatch on process 0's shard: {d_rows}"
            )
        print(
            f"[multihost] {num_processes} processes x {n_local} devices: "
            f"({s} src over ('host','chip') mesh, cross-process psum "
            f"mixdown) max|diff| vs unsharded = {d:.2e}, "
            f"per-source shard rows = {d_rows:.2e} OK",
            flush=True,
        )
    multihost_utils.sync_global_devices("jefferson_multihost_dryrun_done")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--local-devices", type=int, default=None)
    ap.add_argument("--coordinator", required=True)
    args = ap.parse_args(argv)
    _worker(args.process_id, args.num_processes, args.local_devices,
            args.coordinator)
    return 0


if __name__ == "__main__":
    sys.exit(main())
