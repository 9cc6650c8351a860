"""The port's contract checker (``tools/spjoin_lint_torch``).

Everything runs in subprocesses with ``PYTHONPATH=tools:src``, so this
process imports neither the checker nor a world of ``torch.distributed``:

* AST rules: ``tests/lint_fixtures_torch/bad/`` must fire each rule on
  every line marked ``# expect: <rule>`` (a stream scope one site over its
  budget, one under it, a budget-0 scope with one read) and nothing else;
  every file of ``good/`` must lint clean; more waivers than the ratchet
  allows fire once for the tree.
* ``test_port_tree_is_clean``: the tool over ``src/repro_torch`` exits 0,
  and the port ships exactly ``config.MAX_WAIVERS`` waivers (the ratchet
  equals what ships).
* Run-time audit: passes on the port (no float64 op in any ``ops.*``
  wrapper or verify tile; every stage's collectives equal the reference's
  baseline and the port's budget file), drives every public ``backend=``
  op, and rejects an op that yields float64 and a stage with one extra
  collective.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "lint_fixtures_torch"
TIMEOUT_S = 120
EXPECT = re.compile(r"#\s*expect(-next)?:\s*([a-z0-9\-]+)")


def _run(args: list[str]) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "tools"), str(ROOT / "src")])}
    return subprocess.run([sys.executable, *args], capture_output=True, text=True, env=env, cwd=str(ROOT),
                          timeout=TIMEOUT_S)


def _lint(tree: str) -> list[dict]:
    out = _run(["-m", "spjoin_lint_torch", "--json", f"tests/lint_fixtures_torch/{tree}"])
    assert out.returncode in (0, 1), out.stderr
    return json.loads(out.stdout)


def _expected() -> list[tuple[str, int, str]]:
    """(file, line, rule) of every marker in the bad tree."""
    out = []
    for path in sorted((FIXTURES / "bad").rglob("*.py")):
        rel = path.relative_to(ROOT).as_posix()
        for i, text in enumerate(path.read_text().splitlines(), start=1):
            m = EXPECT.search(text)
            if m:
                out.append((rel, i + 1 if m.group(1) else i, m.group(2)))
    return out


EXPECTED = _expected()
GOOD_FILES = sorted(p.relative_to(ROOT).as_posix() for p in (FIXTURES / "good").rglob("*.py"))


@pytest.fixture(scope="module")
def bad():
    return {(v["file"], v["line"], v["rule"]) for v in _lint("bad")}


@pytest.fixture(scope="module")
def good():
    return _lint("good")


@pytest.mark.parametrize("file,line,rule", EXPECTED, ids=[f"{r}@{f.split('repro_torch/')[1]}:{n}"
                                                          for f, n, r in EXPECTED])
def test_bad_fixture_fires(bad, file, line, rule):
    assert (file, line, rule) in bad


def test_bad_fixture_fires_nothing_unmarked(bad):
    ratchet = ("tests/lint_fixtures_torch/bad", 0, "waiver-hygiene")
    assert bad - set(EXPECTED) == {ratchet}


def test_every_rule_has_a_bad_case():
    rules = {r for _, _, r in EXPECTED}
    assert rules == {"host-sync", "dispatch-triad", "f64-cast", "collective-site", "kernel-confined",
                     "layering", "waiver-hygiene"}


@pytest.mark.parametrize("file", GOOD_FILES, ids=lambda f: f.split("repro_torch/")[1])
def test_good_fixture_is_clean(good, file):
    assert [v for v in good if v["file"] == file] == []


def test_good_tree_has_no_violation(good):
    assert good == []


def test_stream_budget_fires_at_budget_plus_one():
    out = _run(["-m", "spjoin_lint_torch", "tests/lint_fixtures_torch/bad/repro_torch/core/verify.py"])
    assert out.returncode == 1
    assert "8 sync site(s) in the loops of stream scope `verify_cell_lists` exceed its budget of 7" in out.stdout
    assert "3 sync site(s) in the loops of stream scope `_flush_window_batch` fall below its budget of 4" \
        in out.stdout
    clean = _run(["-m", "spjoin_lint_torch", "tests/lint_fixtures_torch/good/repro_torch/core/verify.py"])
    assert clean.returncode == 0, clean.stdout


def test_port_tree_is_clean():
    out = _run(["-m", "spjoin_lint_torch", "src/repro_torch"])
    assert out.returncode == 0, out.stdout
    config = _run(["-c", "from spjoin_lint_torch import config; print(config.MAX_WAIVERS)"])
    assert "0 violation(s) across" in out.stdout
    assert f"({config.stdout.strip()} waiver(s) in use)" in out.stdout


AUDIT = """
import json, torch
import torch.distributed as dist
from spjoin_lint_torch import audit, budgets
from repro_torch.core import distributed
from repro_torch.data import synthetic

report, problems = audit.run_audit()
f64 = audit.f64_ops(lambda: torch.ones(3) * torch.ones(3, dtype=torch.float64))
x = torch.as_tensor(synthetic.mixture(64, 4, n_clusters=2, seed=1))
xt, vt, _, _ = distributed._pad_shard_set(x, 1, 0)

def stats_and_one_more():
    distributed.make_stage_stats(backend="torch")(xt, vt)
    distributed._all_gather(torch.ones(2), None, "stats")

counts = (distributed.reset_collective_counts, distributed.collective_counts)
_, extra = audit.audit_collectives({"stage_stats": (counts, stats_and_one_more, budgets.stage_budget("stage_stats"))})
print(json.dumps({"problems": problems, "stages": report["stages"], "f64": f64, "extra": extra,
                  "driven": sorted(report["f64"]), "backend_ops": sorted(audit.backend_ops()),
                  "world_left": dist.is_initialized()}))
"""


@pytest.fixture(scope="module")
def audit():
    out = _run(["-c", AUDIT])
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_runtime_audit_passes_on_the_port(audit):
    assert audit["problems"] == []
    assert audit["stages"]["stage_verify"] == {"verify.all_to_all": 6}
    assert not audit["world_left"]


def test_runtime_audit_drives_every_backend_op(audit):
    assert set(audit["backend_ops"]) <= set(audit["driven"])
    assert {"verify.verify_tile[mask]", "verify.verify_tile_compact[compact]"} <= set(audit["driven"])


def test_runtime_audit_rejects_float64(audit):
    assert audit["f64"], "an op that yields float64 was not recorded"


def test_runtime_audit_rejects_an_extra_collective(audit):
    assert len(audit["extra"]) == 1 and "stage_stats" in audit["extra"][0]
    assert "'stats.all_gather': 4" in audit["extra"][0]
