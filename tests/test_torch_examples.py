"""The port's twins of the examples (`repro_torch.launch.quickstart`,
`repro_torch.launch.hospitals_async`) against the examples themselves:
each JAX example's `main` and its twin's `main(["--device", "cpu"])` run
in this process, and their printed lines are compared line by line.

The text between the numbers is equal.  A number is exact unless its
line's rule says otherwise: objectives within OBJ_RTOL relative, the
fixed-point residual and the gap to the optimum (float32 noise at the
optimum) within RESIDUAL_ATOL, the predictions' drift within DRIFT_RTOL;
a number compared with a tolerance may also differ by half a unit of its
last printed digit.  The float64 simulator's times, objectives and
speedup, the cohort sizes and counts, and the event counts are exact, and
the examples' bitwise claims hold in the twins (they assert them).
"""
import contextlib
import io
import re
import runpy
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.launch import hospitals_async, quickstart  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
OBJ_RTOL, RESIDUAL_ATOL, DRIFT_RTOL = 1e-5, 1e-4, 1e-4
NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")

# (line prefix, {number index: ("rel" | "abs", tolerance)})
RULES = {
    "quickstart": [
        ("[fista]", {0: ("rel", OBJ_RTOL)}),
        ("[smtl ]", {1: ("rel", OBJ_RTOL)}),
        ("[amtl ]  objective", {1: ("rel", OBJ_RTOL),
                                2: ("abs", RESIDUAL_ATOL)}),
        ("[amtl ]  gap", {0: ("abs", RESIDUAL_ATOL)}),
    ],
    "hospitals_async": [
        ("[stream      ] 1920 events", {1: ("rel", OBJ_RTOL),
                                         2: ("rel", OBJ_RTOL)}),
        ("[feedback    ] same events", {0: ("rel", DRIFT_RTOL)}),
    ],
}
TWINS = {"quickstart": quickstart, "hospitals_async": hospitals_async}


def _lines(fn) -> list[str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue().strip().splitlines()


def _close(a: str, b: str, rule) -> bool:
    if rule is None:
        return a == b
    kind, tol = rule
    x, y = float(a), float(b)
    decimals = len(a.split("e")[0].partition(".")[2])
    slack = 0.5 * 10.0 ** -decimals if "e" not in a else 0.0
    if kind == "rel":
        return abs(x - y) <= tol * abs(y) + slack
    return abs(x - y) <= tol + slack


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_prints_the_examples_lines(name):
    example = runpy.run_path(str(EXAMPLES / f"{name}.py"),
                             run_name="example")
    want = _lines(example["main"])
    got = _lines(lambda: TWINS[name].main(["--device", "cpu"]))
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert NUMBER.sub("#", g) == NUMBER.sub("#", w), (g, w)
        rules = next((r for prefix, r in RULES[name]
                      if w.startswith(prefix)), {})
        for i, (a, b) in enumerate(zip(NUMBER.findall(g),
                                       NUMBER.findall(w))):
            assert _close(a, b, rules.get(i)), (i, g, w)


def test_twins_return_their_numbers():
    out = quickstart.main(["--device", "cpu"])
    assert out["resume_bitwise"] and out["resumed_event"] == 2400
    assert out["checkpoint_event"] == 1200
    assert abs(out["amtl"] - out["fista"]) <= OBJ_RTOL * out["fista"]
