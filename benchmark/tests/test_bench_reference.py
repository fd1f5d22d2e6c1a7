"""The plain reference against the program and against hand-worked
pixels, the control that must come out not correct, and the faults of
the timed path that must come out not correct, on the CPU at a small
size."""
import numpy as np
import pytest

import harness
import reference
import refcheck
import scene
import traffic
from conftest import cells


def test_reference_by_hand():
    """swgl's src-over on 8-bit integers: a white ground, a half-covered
    premultiplied texel, a straight colour at alpha 0.5."""
    px = np.zeros((1, 2, 4), np.uint8)
    px[0, 0] = (100, 0, 50, 128)        # premultiplied, alpha 128
    px[0, 1] = (0, 0, 0, 0)
    state = scene.State((3, 1), [
        scene.Item("rect", (0, 0, 3, 1), (1.0, 1.0, 1.0, 1.0)),
        scene.Item("image", (0, 0, 2, 1), key=7),
        scene.Item("rect", (2, 0, 3, 1), (0.2, 0.4, 1.0, 0.5))], {7: px})
    img = reference.compose(state).astype(int)
    # d = 255: d - ((d * 128 + d) >> 8) = 255 - 128 = 127
    assert img[0, 0].tolist() == [100 + 127, 127, 50 + 127, 128 + 127]
    assert img[0, 1].tolist() == [255, 255, 255, 255]
    # premultiplied (0.1, 0.2, 0.5, 0.5) packs to (26, 51, 128, 128)
    assert img[0, 2].tolist() == [26 + 127, 51 + 127, 128 + 127, 255]


@pytest.mark.parametrize("workload", cells())
def test_control_is_not_correct(small_cell, workload):
    cell = small_cell(workload)
    t = traffic.Traffic(cell.config, cell.mix, 2 ** 32 + 3, cell.home)
    for _ in range(3):
        t.step()
    ref = reference.compose(t.state, reference.identity, cell.home)
    ctl = reference.compose(t.state, reference.control_quantize, cell.home)
    got = refcheck.measure(ctl, ref)
    assert got["pixels_off"] > cell.limits["pixels_off"]
    assert got["max_step"] > cell.limits["max_step"]


def _stale(prog):
    """render_device presents its first framebuffer again: a step that
    leaves the state unchanged."""
    r = prog.backend.renderer
    real, first = r.render_device, []

    def stale(frame, resources):
        fb = real(frame, resources)
        if not first:
            first.append(fb.clone())
        return first[0]
    r.render_device = stale


def _one_pixel(prog):
    """One pixel altered where the frame is produced."""
    r = prog.backend.renderer
    real = r.render_device

    def altered(frame, resources):
        fb = real(frame, resources).clone()
        fb[0, 3, 5] = 1.0 - fb[0, 3, 5]
        return fb
    r.render_device = altered


def _lost_transactions(prog):
    """The frames' transactions never reach the backend."""
    be = prog.backend
    real = be.send_transaction
    sent = []

    def lost(txn):
        if not sent:
            sent.append(1)
            return real(txn)
        return None
    be.send_transaction = lost


@pytest.mark.parametrize("workload", cells())
def test_program_matches_reference(small_cell, workload):
    res = harness.run_cell(small_cell(workload), 2 ** 31 + 99, 0.2, False,
                           device="cpu")
    assert res["correct"] is True
    assert res["checks"]["pixels_off"]["value"] == 0


@pytest.mark.parametrize("fault", [_stale, _one_pixel, _lost_transactions])
@pytest.mark.parametrize("workload", cells())
def test_fault_is_not_correct(small_cell, workload, fault):
    cell = small_cell(workload)
    # the first transaction sets the page; the faults act after it
    res = harness.run_cell(cell, 2 ** 31 + 7, 0.2, False, device="cpu",
                           faults=fault)
    assert res["correct"] is False
    assert res["checks"]["pixels_off"]["value"] > 0
