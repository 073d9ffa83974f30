"""The control, the reference in TF32 put in the program's place, fails the
comparison; the float64 reference itself passes it.  At a small size on
the CPU (TF32 by rounding the inputs); ``calibrate.py`` reads the same on
the card at each cell's own size."""
import pytest

from portbench import reference
from portbench.run import Run
from portbench.tests.small import BENCH, CELLS, seconds_for, small_config


@pytest.mark.parametrize("seed", [11, 12, 2**31 + 13])
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_reference_passes(cell, seed):
    run = Run(BENCH, cell, seed, seconds_for(cell), False, "cpu", config=small_config(cell))
    rows = run.kind.compared_rows(run, run.seconds)
    (ri, rv, _), (si, sv, _) = run.R, run.S
    dim, k = run.config["dim"], run.config["k"]
    q = (ri[rows], rv[rows])
    ctl_s, ctl_i = reference.control(q, (si, sv), k, dim, "cpu")
    ctl = reference.judge(q, (si, sv), ctl_i, ctl_s, k, dim, "cpu")
    assert any(ctl[n] > lim for n, lim in run.limits.items() if n in ctl), ctl
    ref_s, ref_i = reference.topk(q, (si, sv), k, dim, "cpu")
    ok = reference.judge(q, (si, sv), ref_i, ref_s, k, dim, "cpu")
    assert all(ok[n] <= lim for n, lim in run.limits.items() if n in ok), ok


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card_at_the_cells_size(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control's TF32 products run on the card")
    from portbench.calibrate import control_numbers
    from portbench.run import Run as _Run

    limits = _Run(BENCH, cell, 1, seconds_for(cell), False, "cuda").limits
    nums = control_numbers(BENCH, cell, 2**31 + 17, BENCH["run_seconds"], "cuda")
    assert any(nums[n] > lim for n, lim in limits.items() if n in nums), nums
