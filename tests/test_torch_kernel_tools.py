"""tools/torch_kernel_compare.py on the CPU: the order its trees run in,
the cases `--only` keeps, and its summary of parent and change runs
(medians, spreads, the verdict, the bit-for-bit check of the weighted
instance)."""

import importlib.util
import os

import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


COMPARE = _tool("torch_kernel_compare")


@pytest.mark.parametrize("changes", [["change"], ["a", "b"], ["a", "b", "c"]])
def test_every_tree_runs_twice_in_turns(changes):
    """Parent, the changes, the changes reversed, parent: each tree twice,
    and the parent's runs around all the others."""
    order = COMPARE.run_order(changes)
    assert order[0] == order[-1] == "parent"
    assert order[1:-1] == changes + changes[::-1]
    assert all(order.count(t) == 2 for t in ["parent"] + changes)


@pytest.mark.parametrize("only,kept", [
    ("", 4),
    ("20k", 2),
    ("^weighted", 2),
    (r"edge_dot \[scores", 1),
    ("hub", 0)])
def test_only_keeps_the_cases_whose_name_matches(only, kept):
    cases = [("weighted", "20k-node GCN batch", None),
             ("weighted", "GCN serving envelope", None),
             ("edge_dot", "scores, 20k-node budget", None),
             ("B1", "serving envelope", None)]
    got = COMPARE.selected(cases, only)
    assert len(got) == kept
    assert all(c in cases for c in got)


def _run(tree, times, out):
    result = {"times_ms": times, "steps": {"gcn": {"busy_ms": 0.7}}}
    return tree, result, out


def test_summary_gives_medians_spreads_and_the_verdict():
    same = {"weighted [a]": torch.ones(3, 2)}
    runs = [_run("parent", {"k": [0.010, 0.011]}, same),
            _run("change", {"k": [0.008, 0.0085]}, same),
            _run("change", {"k": [0.0082, 0.0081]}, same),
            _run("parent", {"k": [0.0105, 0.0102]}, same)]
    shapes, differences, steps, unequal = COMPARE.summarize(runs)
    rec = shapes["k"]
    assert rec["parent"]["median_ms"] == pytest.approx(0.01035)
    assert rec["change"]["spread_ms"] == pytest.approx(0.0005)
    assert rec["faster_beyond_spread"]
    assert rec["change_over_parent"] < 1.0
    assert differences == {"weighted [a]": 0.0} and not unequal
    assert len(steps["parent"]) == len(steps["change"]) == 2


def test_summary_within_the_spread_is_no_gain():
    out = {"edge_dot [b]": torch.zeros(4)}
    runs = [_run("parent", {"k": [0.010, 0.012]}, out),
            _run("change", {"k": [0.0105, 0.0108]}, out)]
    shapes, _, _, _ = COMPARE.summarize(runs)
    assert not shapes["k"]["faster_beyond_spread"]


def test_summary_names_a_weighted_output_that_changed_bits():
    """A weighted output that differs from the parent's in any run is
    reported (the tool then fails); edge_dot's may differ, for the
    record; an empty output differs by nothing."""
    base = {"weighted [a]": torch.ones(2, 2), "edge_dot [b]": torch.ones(3),
            "weighted [empty]": torch.zeros(0, 4)}
    moved = {"weighted [a]": torch.ones(2, 2) + 2.0 ** -20,
             "edge_dot [b]": torch.ones(3) + 1e-7,
             "weighted [empty]": torch.zeros(0, 4)}
    runs = [_run("parent", {"k": [1.0]}, base),
            _run("change", {"k": [1.0]}, moved)]
    _, differences, _, unequal = COMPARE.summarize(runs)
    assert unequal == {"weighted [a]": 2.0 ** -20}
    assert differences["edge_dot [b]"] > 0
    assert differences["weighted [empty]"] == 0.0
