"""The reduced model's CPU logits do not move with the CPU's vector ISA.

``chip_smoke.py`` (phase 14 (c)) holds the card's float32 logits of the
reduced llama3.2-3b to the CPU's within 2e-5 + 2e-5·|logit|, so the CPU
side must give the same answer on every host. Each case runs the reduced
forward (4 x 300 tokens, weights from a seed) in a subprocess with ATen's
and MKL's instruction sets pinned (``ATEN_CPU_CAPABILITY``,
``MKL_ENABLE_INSTRUCTIONS``) and holds it against a run with the host's
own choice: the RoPE tables bit for bit, the logits within that limit.

Run as a script (``PYTHONPATH=src python tests/test_torch_rope_isa.py``)
it prints the same comparison for every ISA this CPU offers, for the
port's RoPE tables and for float32 tables built as the JAX package
builds them.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

_SRC = Path(__file__).resolve().parent.parent / "src"
# ATen's capability and the matching MKL instruction set
_ISAS = {"default": "SSE4_2", "avx2": "AVX2", "avx512": "AVX512"}


def _forward(out: str) -> None:
    """Save the reduced forward's logits and RoPE tables, with the port's
    tables and with float32 ones, to ``out`` (an .npz)."""
    import torch
    from repro_torch import configs
    from repro_torch.models import ModelOptions, forward, init_params, layers

    def tables_f32(positions, dh_half, theta):
        e = torch.arange(dh_half, dtype=torch.float32) / dh_half
        freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32), e)
        angles = positions[..., None].to(torch.float32) * freqs
        return torch.cos(angles), torch.sin(angles)

    cfg = configs.get_reduced("llama3.2-3b")
    opts = ModelOptions(dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(2), opts,
                         device="cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 300)))
    res = {"isa": torch.backends.cpu.get_cpu_capability()}
    port = layers.rope_tables
    try:
        for name, fn in (("port", port), ("f32", tables_f32)):
            layers.rope_tables = fn
            res[name], _ = forward(params, cfg, toks, opts=opts)
            res[name + "_tables"] = torch.cat(
                fn(torch.arange(300)[None, :], cfg.dh // 2, cfg.rope_theta))
    finally:
        layers.rope_tables = port
    np.savez(out, **{key: np.asarray(val) for key, val in res.items()})


def _run(out: Path, isa: str | None) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(_SRC) + os.pathsep + env.get("PYTHONPATH", "")
    if isa is not None:
        env["ATEN_CPU_CAPABILITY"] = isa
        env["MKL_ENABLE_INSTRUCTIONS"] = _ISAS[isa]
    subprocess.run([sys.executable, __file__, "--forward", str(out)],
                   env=env, check=True, timeout=300)
    with np.load(out) as f:
        return {key: f[key] for key in f.files}


def _diff(a: dict, b: dict, name: str) -> tuple[float, float, float]:
    """(max |logit diff|, its share of 2e-5 + 2e-5·|logit|, max |table
    diff|) of two runs."""
    d = np.abs(a[name] - b[name])
    used = float((d / (2e-5 + 2e-5 * np.abs(b[name]))).max())
    return (float(d.max()), used,
            float(np.abs(a[name + "_tables"] - b[name + "_tables"]).max()))


@pytest.fixture(scope="module")
def host_run(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("isa") / "host.npz", None)


@pytest.mark.parametrize("isa", ["default", "avx2"])
def test_reduced_logits_agree_across_cpu_isas(host_run, isa, tmp_path):
    run = _run(tmp_path / f"{isa}.npz", isa)
    assert str(run["isa"]) == isa.upper()
    _, used, table_diff = _diff(run, host_run, "port")
    assert table_diff == 0.0
    assert used <= 1.0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--forward"]:
        _forward(sys.argv[2])
        sys.exit(0)
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        host = _run(Path(tmp) / "host.npz", None)
        print(f"host's own ISA {host['isa']}; each run against it "
              f"(limit 2e-5 + 2e-5·|logit|)")
        for isa in _ISAS:
            run = _run(Path(tmp) / f"{isa}.npz", isa)
            if str(run["isa"]) != isa.upper():
                print(f"{isa}: not offered by this CPU (ran {run['isa']})")
                continue
            for name, what in (("port", "port's float64-rounded tables"),
                               ("f32", "float32 tables, as the JAX package")):
                d, used, t = _diff(run, host, name)
                print(f"{isa:>8} {what}: logits max |diff| {d:.3e} "
                      f"({used:.3f} of the limit), tables max |diff| {t:.3e}")
