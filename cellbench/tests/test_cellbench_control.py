"""The control on the card at each cell's own size: the reference in
bfloat16 put in the program's place comes out not correct on three
seeds, while the program's own run comes out correct
(``python -m pytest cellbench/tests -m cuda``, about 5 minutes)."""
import pytest

from cellbench.control import readings
from cellbench.run import BENCH_DIR, ROOT, cell_entry, load_json

BENCH = load_json(ROOT / "BENCHMARK.json")
SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_on_the_card(card, workload):
    cell = cell_entry(BENCH, workload)
    limits = load_json(BENCH_DIR / "traffic"
                       / f"{cell['traffic']}.json")["limits"]
    for row in readings(workload, SEEDS, 2.0, ("lowp",)):
        assert all(row["program"][k] <= lim for k, lim in limits.items()), \
            row
        assert any(row["lowp"][k] > lim for k, lim in limits.items()), row
