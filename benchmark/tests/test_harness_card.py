"""On the card: one short run of each cell through the command line, its
result line whole and ``correct`` true. Run there with
``python3 -m pytest -m cuda benchmark/tests``."""

import json
import subprocess
import sys

import pytest

from benchmark import core


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w.name for w in core.load_cells()])
def test_a_short_run_on_the_card(card, name):
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", name, "--seed",
                        str(2 ** 31 + 99), "--seconds", "5", "--trace", "0"], cwd=core.ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert line["metrics"]["setup_s"]["value"] > 0
    assert p.stderr.strip().splitlines()[-1].startswith("[check]")
