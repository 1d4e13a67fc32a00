"""In-process line-coverage audit for the test suite (no coverage.py needed).

This environment has no coverage tooling installed, so this script uses
CPython 3.12's ``sys.monitoring`` directly: LINE events are DISABLE'd per
location after the first hit, making steady-state overhead near zero (the
full suite runs at ordinary speed).  Executable lines are derived from
compiled code objects (``co_lines``), so docstrings/comments don't count.

    python scripts/coverage_audit.py [pytest args...]       # default: tests/ -q

Subprocess coverage: children the suite spawns (multihost workers, CLI
subprocess drives, daemon soaks) are counted too, via an injected
``sitecustomize`` hook: a temp dir prepended to ``PYTHONPATH`` arms the same
DISABLE-after-first-hit LINE monitoring in every child, dumps per-process
hits to ``$JCOV_DIR`` at exit, and CHAINS to any sitecustomize it shadows
(an installation's own site hook must keep running).  Children
killed hard (SIGKILL reaps in the multihost harness' failure path) simply
don't report; children spawned with a scrubbed env don't either.  The report
prints the in-process total (comparable to earlier rounds' rows: 89.2% at
306 tests, 95.7% at 370+) and the merged total.
"""

import json
import os
import sys
import tempfile
import uuid
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
PREFIX = str(REPO / "jefferson_tpu") + "/"
TOOL = 4  # any free sys.monitoring tool id

hits: dict[str, set[int]] = {}
mon = sys.monitoring
mon.use_tool_id(TOOL, "jcov")


def _on_line(code, line):
    fn = code.co_filename
    if fn.startswith(PREFIX):
        s = hits.get(fn)
        if s is None:
            s = hits[fn] = set()
        s.add(line)
    return mon.DISABLE


def _executable_lines(path: Path) -> set[int]:
    try:
        code = compile(path.read_text(), str(path), "exec")
    except SyntaxError:
        return set()
    lines: set[int] = set()
    stack = [code]
    while stack:
        c = stack.pop()
        # ln 0 is the synthetic module-prologue entry (RESUME etc.) — it can
        # never be hit by a LINE event, so counting it inflates every file's
        # missed set by one (the "worst: 0" artifact in earlier reports)
        lines.update(ln for _, _, ln in c.co_lines() if ln)
        stack.extend(k for k in c.co_consts if hasattr(k, "co_lines"))
    return lines


# Injected into every child interpreter via PYTHONPATH.  Arms coverage FIRST
# (so a failing chain can't lose it), then execs the sitecustomize it shadows
# from the next sys.path entry that has one.
_CHILD_HOOK = '''\
import atexit, json, os, sys, uuid

def _arm():
    cov_dir = os.environ.get("JCOV_DIR")
    prefix = os.environ.get("JCOV_PREFIX")
    if not cov_dir or not prefix:
        return
    mon = sys.monitoring
    TOOL = 4
    try:
        mon.use_tool_id(TOOL, "jcov-child")
    except ValueError:
        return  # something already owns the slot; skip, don't break the child
    hits = {}
    def _on_line(code, line):
        fn = code.co_filename
        if fn.startswith(prefix):
            s = hits.get(fn)
            if s is None:
                s = hits[fn] = set()
            s.add(line)
        return mon.DISABLE
    mon.register_callback(TOOL, mon.events.LINE, _on_line)
    mon.set_events(TOOL, mon.events.LINE)
    def _dump():
        try:
            mon.set_events(TOOL, 0)
            if not hits:
                return
            out = os.path.join(cov_dir, f"{os.getpid()}-{uuid.uuid4().hex}.json")
            with open(out, "w") as f:
                json.dump({k: sorted(v) for k, v in hits.items()}, f)
        except Exception:
            pass  # coverage must never fail a child's real work
    atexit.register(_dump)

def _chain():
    here = os.path.dirname(os.path.abspath(__file__))
    for p in list(sys.path):
        try:
            ap = os.path.abspath(p or os.getcwd())
        except OSError:
            continue
        if ap == here:
            continue
        cand = os.path.join(ap, "sitecustomize.py")
        if os.path.exists(cand):
            import importlib.util
            spec = importlib.util.spec_from_file_location(
                "sitecustomize_chained", cand)
            mod = importlib.util.module_from_spec(spec)
            try:
                spec.loader.exec_module(mod)
            except Exception:
                pass  # mirror site.py: a broken sitecustomize is non-fatal
            break

_arm()
_chain()
'''


def _install_child_hook() -> Path:
    """Create the hook dir, point children at it, return the dump dir."""
    cov_dir = Path(tempfile.mkdtemp(prefix="jcov_"))
    hook_dir = cov_dir / "hook"
    hook_dir.mkdir()
    (hook_dir / "sitecustomize.py").write_text(_CHILD_HOOK)
    os.environ["JCOV_DIR"] = str(cov_dir)
    os.environ["JCOV_PREFIX"] = PREFIX
    existing = os.environ.get("PYTHONPATH", "")
    os.environ["PYTHONPATH"] = str(hook_dir) + (
        os.pathsep + existing if existing else ""
    )
    return cov_dir


def _merge_child_dumps(cov_dir: Path) -> int:
    n = 0
    for f in cov_dir.glob("*.json"):
        try:
            data = json.loads(f.read_text())
        except (OSError, json.JSONDecodeError):
            continue  # a child died mid-write; its partial dump is garbage
        for fn, lines in data.items():
            hits.setdefault(fn, set()).update(lines)
        n += 1
    return n


def _ranges(sorted_lines):
    out, start, prev = [], None, None
    for ln in sorted_lines:
        if start is None:
            start = prev = ln
        elif ln == prev + 1:
            prev = ln
        else:
            out.append((start, prev))
            start = prev = ln
    if start is not None:
        out.append((start, prev))
    return out


def main() -> int:
    cov_dir = _install_child_hook()
    mon.register_callback(TOOL, mon.events.LINE, _on_line)
    mon.set_events(TOOL, mon.events.LINE)
    import pytest

    argv = sys.argv[1:] or ["tests/", "-q"]
    rc = pytest.main(argv)
    mon.set_events(TOOL, 0)

    in_process = {k: set(v) for k, v in hits.items()}
    n_children = _merge_child_dumps(cov_dir)

    rows = []
    inproc_cov = 0
    for path in sorted((REPO / "jefferson_tpu").rglob("*.py")):
        ex = _executable_lines(path)
        if not ex:
            continue
        missed = sorted(ex - hits.get(str(path), set()))
        inproc_cov += len(ex & in_process.get(str(path), set()))
        rows.append((len(missed), len(ex), path, missed))
    rows.sort(reverse=True, key=lambda r: r[0])
    total_ex = sum(r[1] for r in rows)
    total_miss = sum(r[0] for r in rows)
    print(f"\nTOTAL (in-process): {inproc_cov}/{total_ex} executable lines "
          f"({100 * inproc_cov / total_ex:.1f}%)")
    print(f"TOTAL (+{n_children} subprocess dumps): "
          f"{total_ex - total_miss}/{total_ex} executable lines "
          f"({100 * (1 - total_miss / total_ex):.1f}%)\n")
    for missed_n, ex_n, path, missed in rows[:20]:
        rel = path.relative_to(REPO)
        rr = sorted(_ranges(missed), key=lambda ab: ab[0] - ab[1])
        shown = ", ".join(f"{a}-{b}" if b > a else str(a) for a, b in rr[:10])
        print(f"{rel}: {100 * (1 - missed_n / ex_n):.0f}% "
              f"({missed_n}/{ex_n} missed)  worst: {shown}")
    out = REPO / "coverage_lines.json"
    out.write_text(json.dumps({k: sorted(v) for k, v in hits.items()}))
    print(f"\nper-line hits -> {out}")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
