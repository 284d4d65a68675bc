"""chip_smoke.py's phases at a tiny size on the CPU: the same code the GPU
run executes, with the shapes cut down (the script itself refuses a CPU,
which is checked too)."""

import dataclasses

import jax
import numpy as np
import pytest

import chip_smoke

TINY = chip_smoke.Size(hidden=8, n_iters=2, n_layers=6, n_tracks=4, k=3,
                       group=2, n_graphs=4, n_sectors=3, n_npz=16,
                       n_epochs=3, scan_steps=2)


def test_main_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert "needs a GPU" in str(exc.value.code)
    assert '"ok"' not in capsys.readouterr().out


def test_phase_parity_tiny(capsys):
    chip_smoke.phase_parity(TINY, jax.devices("cpu")[0])
    out = capsys.readouterr().out
    for route in chip_smoke.ROUTES:
        for mode in ("f32-highest", "f32-default", "bf16"):
            assert f"phase1 {route:7s} {mode}" in out
    assert "phase1 fullevent sparse" in out
    assert "phase1 fullevent blocked" in out


def test_oracle_gradients_match_autodiff_of_sparse_route():
    """The float64 oracle's gradients are the sparse route's gradients to
    f32 accuracy (the reference the GPU gradients are held to)."""
    g, cfg = chip_smoke.sectors(TINY, 2, seed=7)
    g = chip_smoke.with_blocks(TINY, g, cfg)
    mcfg = chip_smoke.model_cfg(TINY, "sparse")
    params = chip_smoke.mpnn.init_segment_classifier(jax.random.PRNGKey(7),
                                                     mcfg)
    probs, grads = chip_smoke.oracle_reference(params, g, TINY.n_iters)
    loss, p32, g32 = chip_smoke.run_on(jax.devices("cpu")[0], params, g,
                                       mcfg)
    real = np.asarray(g.edge_mask) > 0
    np.testing.assert_allclose(p32[real], probs[real], atol=1e-5)
    assert chip_smoke.grad_rel_err(g32, grads) < 1e-4


def test_parity_tolerance_catches_a_wrong_route(monkeypatch):
    """A route whose output is off fails phase 1 (no silent pass)."""
    real_run_on = chip_smoke.run_on

    def skewed(device, params, graph, cfg):
        loss, probs, grads = real_run_on(device, params, graph, cfg)
        return loss, probs + 0.05, grads

    monkeypatch.setattr(chip_smoke, "run_on", skewed)
    with pytest.raises(AssertionError, match="max\\|dp\\|"):
        chip_smoke.phase_parity(TINY, jax.devices("cpu")[0])


def test_phase_front_door_tiny(capsys, caplog):
    caplog.set_level("INFO")
    chip_smoke.phase_front_door(TINY)
    out = capsys.readouterr().out
    assert "phase2 train losses per epoch" in out
    assert f"phase2 resumed: epoch {TINY.n_epochs + 1}" in out
    assert "Latency:" in caplog.text


def test_phase_scan_tiny(capsys):
    chip_smoke.phase_scan(TINY)
    out = capsys.readouterr().out
    assert "phase3 memory_analysis" in out
    assert "information only" in out


def test_phase_four_on_virtual_devices(capsys):
    """--four's dp and partitioned steps on 4 of the 8 virtual CPU
    devices, each against one device."""
    assert len(jax.devices()) >= 4
    chip_smoke.phase_four(dataclasses.replace(TINY, n_tracks=6),
                          jax.devices())
    out = capsys.readouterr().out
    assert "four dp:" in out and "four partitioned:" in out


@pytest.mark.gpu
def test_parity_at_full_width_on_gpu():
    """Phase 1 at the real sizes, on the card."""
    chip_smoke.phase_parity(chip_smoke.Size(), jax.devices()[0])
