"""Device-mesh utilities for multi-device scaling.

The reference is single-GPU; its parallelism is 8 CUDA streams per source
(reference: Jefferson/src/GPUSoundSource.cu:20,36-38).  The rebuild's
scaling story is a 1-D (or 2-D) ``jax.sharding.Mesh``: independent source
streams shard across devices with zero hot-path collectives; the only
reduction is the optional mixdown (GSPMD inserts a psum over the source
axis).  Multi-host would extend the same mesh (parallel/multihost.py).

The mesh follows the algorithm alone: every device of a host reaches every
other at the same rate, so devices are taken in ``jax.devices()`` order.

Axis conventions:
  * ``src``  — data-parallel over concurrent source streams
  * ``blk``  — parallel over time blocks of one render (offline only;
               blocks are independent given the input)
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def xla_flags_with_device_count(flags: str, n: int) -> str:
    """``flags`` with any existing host-device-count flag REPLACED by n.

    The one shared implementation of the scrub-and-set dance (dryrun
    parent, re-exec parent, child force, multihost worker): append-or-skip
    variants let an inherited flag with a DIFFERENT count win silently."""
    kept = [
        f for f in flags.split()
        if "xla_force_host_platform_device_count" not in f
    ]
    kept.append(f"--xla_force_host_platform_device_count={n}")
    return " ".join(kept)


def make_mesh(n_devices: int | None = None, axis_names: tuple[str, ...] = ("src",)) -> Mesh:
    """1-D mesh over the first n devices (default: all)."""
    devs = jax.devices()
    n = len(devs) if n_devices is None else n_devices
    if n < 1:
        # 0 used to silently mean "all" and negatives silently dropped
        # devices off the end — both mask a caller's arithmetic bug
        raise ValueError(f"n_devices must be >= 1, got {n}")
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    if len(axis_names) == 1:
        arr = np.array(devs[:n])
    elif len(axis_names) == 2:
        # favor a near-square factorization for 2-D meshes
        a = int(np.floor(np.sqrt(n)))
        while n % a:
            a -= 1
        arr = np.array(devs[:n]).reshape(a, n // a)
    else:
        raise ValueError("only 1-D or 2-D meshes supported")
    return Mesh(arr, axis_names)


def force_virtual_cpu(n: int) -> None:
    """Switch THIS process to an n-device virtual CPU platform.

    The child-process side of the re-exec dance (shared by
    ensure_virtual_devices and __graft_entry__'s dryrun): set the
    device-count flag before any backend is created, then force the
    platform via jax.config (it wins over an earlier JAX_PLATFORMS).  An inherited
    flag with a DIFFERENT count is REPLACED, not kept (a stale count from
    the shell or an earlier re-exec used to win silently)."""
    os.environ["XLA_FLAGS"] = xla_flags_with_device_count(
        os.environ.get("XLA_FLAGS", ""), n
    )
    jax.config.update("jax_platforms", "cpu")


def ensure_virtual_devices(n: int) -> None:
    """Make sure >= n jax devices exist, re-execing the current script onto
    an n-device virtual CPU mesh if necessary — the CPU dry run of a mesh
    path, for hosts with fewer devices than the mesh needs.

    Call this at the top of a script (before any other backend use).  Three
    cases:
      * child marker set: we ARE the re-exec'd child — force the CPU
        platform via ``jax.config`` and return.
      * enough devices already: return (no-op).
      * too few devices: re-exec ``sys.argv`` in a subprocess configured for
        an n-device virtual CPU mesh, then exit with its return code.
    """
    if os.environ.get("JT_VIRTUAL_MESH") == "1":
        force_virtual_cpu(n)
        if len(jax.devices()) < n:
            # the flag replacement above came too late (a backend already
            # initialized with an inherited smaller count) — fail loudly
            # instead of letting make_mesh(n) (or silent under-sharding)
            # surface it far from the cause
            raise RuntimeError(
                f"virtual CPU mesh has {len(jax.devices())} device(s) < "
                f"requested {n}: the jax backend initialized before "
                f"ensure_virtual_devices({n}) could set the device count "
                f"(call it before any other backend use)"
            )
        return
    if len(jax.devices()) >= n:
        return
    env = dict(os.environ)
    env["XLA_FLAGS"] = xla_flags_with_device_count(env.get("XLA_FLAGS", ""), n)
    env["JAX_PLATFORMS"] = "cpu"
    env["JT_VIRTUAL_MESH"] = "1"
    print(
        f"[jefferson_tpu] CPU dry run: {len(jax.devices())} device(s) < {n}; "
        f"re-exec on an {n}-device virtual CPU mesh (no accelerator runs this)",
        file=sys.stderr,
    )
    # preserve `python -m pkg.mod` invocations: under -m, sys.argv[0] is the
    # module FILE, and re-running it as a plain script loses the package
    # context (relative imports break)
    import __main__

    spec = getattr(__main__, "__spec__", None)
    if spec is not None and spec.name:
        cmd = [sys.executable, "-m", spec.name] + sys.argv[1:]
    else:
        cmd = [sys.executable] + sys.argv
    rc = subprocess.call(cmd, env=env)
    sys.exit(rc)


def source_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Shard the leading (source) axis, replicate the rest."""
    return NamedSharding(mesh, P(mesh.axis_names[0], *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
