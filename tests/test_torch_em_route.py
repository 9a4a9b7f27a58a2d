"""The port's EM route (em/em.py em_route_name, em_route) against the JAX
package's decisions.

  - em_route_name picks what the JAX package's resolve_em_mxu and
    resolve_em_segsum pick on a machine without a TPU, with the one-hot
    step, which the port does not have, read as the scatter route;
  - em_route plans a segmented sum exactly when that route is segsum;
  - em_segsum "auto" takes the route by the tables' device: segsum on
    CUDA, the scatter on the CPU; "off" and --em-mxu on keep the scatter,
    "on" keeps segsum; the CLI's route line names the route em_route
    takes on that device;
  - --em-mxu on (with or without --em-segsum on) runs the scatter route
    bit for bit.
"""

import itertools

import numpy as np
import pytest
import torch

from sketch_rna_tpu.em import em as jax_em
from sketch_rna_tpu_torch import cli
from sketch_rna_tpu_torch.config import QuantConfig
from sketch_rna_tpu_torch.em import em as port_em
from sketch_rna_tpu_torch.em.em import assign_reads_tables, em_route, em_route_name, run_em_tables
from sketch_rna_tpu_torch.em.segsum import plan_from_tables

MODES = ["auto", "on", "off"]


def _tables(rng, T):
    out = []
    for n, w in ((257, 8), (64, 16)):
        tid = rng.integers(0, T, (n, w)).astype(np.int32)
        score = rng.integers(0, 5, (n, w)).astype(np.int32)
        score[rng.random(n) < 0.2] = 0  # rows with a zero denominator
        out.append((torch.from_numpy(tid), torch.from_numpy(score), torch.from_numpy(rng.integers(0, 7, n))))
    return out


@pytest.mark.parametrize("mxu,segsum,shape,dtype", list(itertools.product(
    MODES, MODES, [(200, 5_000), (1_000, 3_000_000)], ["float32", "float64"])))
def test_route_name_mirrors_jax(mxu, segsum, shape, dtype):
    """(200, 5,000) lies inside the JAX one-hot gate's footprint, (1,000,
    3,000,000) outside; off a TPU neither moves the decision."""
    T, lanes = shape
    use_mxu = jax_em.resolve_em_mxu(mxu, T, lanes, dtype)
    want = "segsum" if jax_em.resolve_em_segsum(segsum, dtype, use_mxu, lanes, T) else "scatter"
    assert em_route_name(mxu, segsum) == want


def _expected_route(mxu, segsum, device_type):
    """--em-mxu on -> scatter; --em-segsum off -> scatter, on -> segsum;
    auto -> segsum on CUDA, the scatter (the JAX package's choice) on the
    CPU."""
    if mxu == "on" or segsum == "off":
        return "scatter"
    if segsum == "on":
        return "segsum"
    return {"cuda": "segsum", "cpu": "scatter"}[device_type]


class _CardLanes:
    """A stand-in for a table's tid tensor on a card: em_route reads the
    device alone before it plans."""

    device = torch.device("cuda")


@pytest.mark.parametrize("mxu,segsum,device_type", list(itertools.product(MODES, MODES, ["cpu", "cuda"])))
def test_route_follows_the_tables_device(monkeypatch, capsys, mxu, segsum, device_type):
    T = 300
    config = QuantConfig(em_mxu=mxu, em_segsum=segsum)
    if device_type == "cuda":
        monkeypatch.setattr(port_em, "plan_from_tables", lambda tables, T: "plan")
        tables = [(_CardLanes(), None, None)]
    else:
        tables = _tables(np.random.default_rng(7), T)
    want = _expected_route(mxu, segsum, device_type)
    route = em_route(tables, T, config)
    assert route["use_segsum"] == (want == "segsum") == (route["segsum_plan"] is not None)
    assert em_route_name(mxu, segsum, device_type) == want
    cli._report_route("fused", "python", config, torch.device(device_type))
    lines = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("quant route:")]
    assert lines == [f"quant route: fused, feed: python, em: {want}"]


@pytest.mark.parametrize("mxu,segsum", list(itertools.product(MODES, MODES)))
def test_em_route_plans_only_for_segsum(mxu, segsum):
    T = 300
    tables = _tables(np.random.default_rng(5), T)
    route = em_route(tables, T, QuantConfig(em_mxu=mxu, em_segsum=segsum))
    assert route["use_segsum"] == (em_route_name(mxu, segsum) == "segsum")
    if not route["use_segsum"]:
        assert route["segsum_plan"] is None
        return
    for got, want in zip(route["segsum_plan"], plan_from_tables(tables, T)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_em_mxu_on_is_the_scatter_route(dtype):
    T = 300
    tables = _tables(np.random.default_rng(6), T)
    kw = dict(num_transcripts=T, dtype=dtype)
    pi_s, it_s, _ = run_em_tables(tables, 500, **kw)
    w_s, h_s = assign_reads_tables(tables, pi_s, **kw)
    for segsum in MODES:
        route = em_route(tables, T, QuantConfig(em_mxu="on", em_segsum=segsum))
        pi, it, _ = run_em_tables(tables, 500, **kw, **route)
        w, h = assign_reads_tables(tables, pi, **kw, **route)
        assert it == it_s and torch.equal(pi, pi_s) and torch.equal(w, w_s) and torch.equal(h, h_s)
