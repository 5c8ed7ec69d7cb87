"""A pytest plugin that watches ``torch.exp`` across a whole test session
(ROADMAP C, the first-training state of whole-suite runs).

    PYTHONPATH=tests python -m pytest tests/ -p torch_tripwire_plugin ...

It is loaded only with ``-p`` on the command line (never from
``tests/conftest.py``), so the suite's own runs do not import it.  At
start-up it takes the bits of ``torch.exp`` on the same fixed f32 probes
as ``torch_port_fixtures.exp_tripwire``; after every test, port-side and
JAX-side alike (``pytest_runtest_logfinish``), it compares them again and
notes the test files in the order the process runs them.  At the end
each process (each xdist worker, or the one process) writes
``tripwire-<worker>.json`` into ``$LGBT_TRIPWIRE_DIR`` (default
``lightgbm_torch/_build/tripwire``, git-ignored): its file order, the
count of tests run, the first test after which the bits differed (null
when they never did) and the last one before it.  The controller prints
one line a worker.  It changes no test's outcome.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import torch

_PROBES = (torch.linspace(-80.0, 80.0, 4099, dtype=torch.float32),
           torch.tensor([-1.5, -1e-3, 0.0, 0.25, 1.0, 7.5, 30.0]))


def _bits():
    return [torch.exp(p).view(torch.int32).clone() for p in _PROBES]


_START = _bits()
_STATE = {"files": [], "tests": 0, "first_bad": None, "bad_values": 0,
          "last_clean": "(session start)"}


def _out_dir(config) -> Path:
    d = os.environ.get("LGBT_TRIPWIRE_DIR")
    if d:
        return Path(d)
    return Path(str(config.rootpath)) / "lightgbm_torch" / "_build" / \
        "tripwire"


def _worker(config) -> str:
    inp = getattr(config, "workerinput", None)
    return inp["workerid"] if inp else "main"


def pytest_configure(config):
    _STATE["config"] = config


def pytest_runtest_logfinish(nodeid, location):
    path = nodeid.split("::")[0]
    if not _STATE["files"] or _STATE["files"][-1] != path:
        _STATE["files"].append(path)
    _STATE["tests"] += 1
    now = _bits()
    bad = sum(int((a != b).sum()) for a, b in zip(now, _START))
    if bad and _STATE["first_bad"] is None:
        _STATE["first_bad"] = nodeid
        _STATE["bad_values"] = bad
    elif not bad and _STATE["first_bad"] is None:
        _STATE["last_clean"] = nodeid


def pytest_sessionfinish(session, exitstatus):
    config = session.config
    d = _out_dir(config)
    worker = _worker(config)
    if getattr(config, "workerinput", None) is not None or \
            not config.pluginmanager.hasplugin("dsession"):
        d.mkdir(parents=True, exist_ok=True)
        rec = {k: v for k, v in _STATE.items() if k != "config"}
        rec.update(worker=worker, probe_values=sum(p.numel()
                                                   for p in _PROBES))
        (d / f"tripwire-{worker}.json").write_text(json.dumps(rec, indent=1))


def pytest_terminal_summary(terminalreporter, exitstatus, config):
    if getattr(config, "workerinput", None) is not None:
        return
    d = _out_dir(config)
    for path in sorted(d.glob("tripwire-*.json")):
        try:
            rec = json.loads(path.read_text())
        except (OSError, ValueError):
            continue
        terminalreporter.write_line(
            f"tripwire {rec['worker']}: {rec['tests']} tests in "
            f"{len(rec['files'])} files, first bad "
            f"{rec['first_bad']} ({rec['bad_values']} values), last clean "
            f"{rec['last_clean']}")
