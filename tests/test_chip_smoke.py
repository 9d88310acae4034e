"""`chip_smoke.py` phases at tiny sizes on the virtual CPU devices, its
device gate, and the compile-cache helper the entry points call.

The phases compare against the same reference they use on the GPU; here
both sides run on CPU devices, so what is tested is the control flow, the
entry points and the checks themselves, not the card.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = chip_smoke.Sizes(
    n_mc=20, n_iters=300, n_bound=20000, n_starts=2, ia_iters=600,
    ia_window=50, ia_tail=200, large_d=4, large_n_mc=50, large_iters=1500,
    large_bound=20000, precision_n=2000, fit_iters=50, fit_bound=2000,
    resume_iters=200, mesh_bound=40000, mesh_starts=2, mesh_start_bound=8000,
    perturb_scale=0.05, check_khat_band=False, mesh_khat_tol=0.5)


@pytest.fixture
def single_device(monkeypatch):
    """The CLI and the service place work on every attached device; pin
    them to one, as on a one-GPU host."""
    import viabel_tpu.parallel as par
    monkeypatch.setattr(par, 'auto_mesh', lambda *a, **k: (None, None))


def test_device_gate_refuses_cpu():
    with pytest.raises(SystemExit) as e:
        chip_smoke.device_gate()
    assert 'needs an NVIDIA GPU' in str(e.value.code)


def test_script_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    r = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert 'no CPU fallback' in r.stderr


def test_fused_phase_and_cli(single_device, capsys):
    devs = jax.devices()
    out = chip_smoke.phase_fused(TINY, devs[0], devs[1])
    assert np.isfinite(out['khat'])
    assert chip_smoke.phase_cli(TINY, out['khat']) == pytest.approx(
        out['khat'], abs=1e-3)
    assert 'max |q_mean - reference|: 0' in capsys.readouterr().out


def test_fused_phase_fails_on_a_wrong_reference(monkeypatch):
    """The comparison is a real check: a reference fit that lands
    elsewhere fails the phase."""
    devs = jax.devices()
    real = chip_smoke.fused_fit

    def shifted(sz, device=None, **kw):
        out = real(sz, device, **kw)
        if device is devs[1]:
            out['q_mean'] = out['q_mean'] + 1.0
        return out
    monkeypatch.setattr(chip_smoke, 'fused_fit', shifted)
    with pytest.raises(chip_smoke.SmokeFailure, match='q_mean'):
        chip_smoke.phase_fused(TINY, devs[0], devs[1])


def test_batched_phase():
    ms = chip_smoke.phase_batched(TINY)
    assert len(ms['bounds']) == TINY.n_starts


def test_large_d_phase_and_precision():
    out = chip_smoke.phase_large_d(TINY)
    assert out['khat'] < 0.7
    errs = chip_smoke.full_rank_precision(20, 1000)
    assert errs['transform'] < 1e-5 and errs['log_prob'] < 1e-5


def test_service_phase(single_device):
    fit = chip_smoke.fused_fit(TINY)
    replies = chip_smoke.phase_service(TINY, fit['opt_param'])
    assert set(replies) == {'health', 'moments', 'sample', 'bounds',
                            'log_prob', 'fit'}


def test_resume_phase_is_bit_identical():
    assert chip_smoke.phase_resume(TINY) is True


def test_mesh_phase_on_four_devices():
    out = chip_smoke.phase_mesh(TINY, jax.devices()[:4])
    assert len(out['validated_vi']['log_weights'].sharding.device_set) == 4


def test_compile_cache_uses_env_dir(monkeypatch, tmp_path):
    from viabel_tpu.utils import enable_compile_cache
    monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # JAX reads env


def test_compile_cache_defaults_to_repo_dir(monkeypatch):
    from viabel_tpu.utils import enable_compile_cache
    from viabel_tpu.utils.cache import DEFAULT_CACHE_DIR
    monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update('jax_compilation_cache_dir', None)
        assert enable_compile_cache() == DEFAULT_CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == DEFAULT_CACHE_DIR
    finally:
        jax.config.update('jax_compilation_cache_dir', before)
    assert DEFAULT_CACHE_DIR == os.path.join(REPO, '.jax_cache')
    with open(os.path.join(REPO, '.gitignore')) as f:
        assert '.jax_cache/' in f.read().split()
