"""The port's analysis tiers against the JAX package's, on the seven
``analyzable()`` examples.

Both packages build each example's graph (the same vertex ids and
labels), propagate specs, price memory and the roofline, and certify it
for serving; JAX runs on a one-device mesh, and both use a chunk of 256
rows and JAX's CPU machine (50 GFLOP/s, 20 GB/s), so the numbers compare.

Stated differences, each with its cause:

- ``MaxClassifier``'s output: JAX's int32 (x64 off), torch's argmax
  int64. Integer leaves compare as "an integer"; that stage's boundary
  bytes differ by the width.
- Stage FLOPs within ``FLOP_RTOL``: the port prices the aten ops a body
  runs on meta tensors, JAX the jaxpr's primitives (`_eqn_cost`); an FFT
  of 64 real points is 5·64·log2 64 in JAX's ``fft`` and 5·33-point
  halves in torch's ``_fft_r2c``, and similar small gaps.
- Movement bytes are not compared: a torch view moves nothing, where
  JAX's reshape and transpose count. The KP80x findings they feed are
  compared, and are the same.
- The seeded (ingress) certificates' bounds within ``BOUND_RTOL``: the
  SIFT and LCS stages' FLOPs differ as above.
"""

import os

import numpy as np
import pytest
import torch

import jax
from keystone_tpu.analysis import as_source_spec as jax_source_spec
from keystone_tpu.analysis.examples import EXAMPLES as JAX_EXAMPLES
from keystone_tpu.analysis.examples import build_example as jax_build
from keystone_tpu.analysis.memory import memory_pass as jax_memory_pass
from keystone_tpu.analysis.propagate import spec_pass as jax_spec_pass
from keystone_tpu.analysis.roofline import Machine as JaxMachine
from keystone_tpu.analysis.roofline import roofline_pass as jax_roofline
from keystone_tpu.analysis.serving import certify_example as jax_certify
from keystone_tpu.analysis.specs import is_known as jax_known
from keystone_tpu.parallel.mesh import make_mesh, use_mesh
from keystone_tpu.workflow.env import config_override as jax_config
from keystone_tpu_torch.analysis import (
    DataSpec,
    Machine,
    as_source_spec,
    memory_pass,
    roofline_pass,
    spec_pass,
)
from keystone_tpu_torch.analysis.examples import EXAMPLES, build_example
from keystone_tpu_torch.analysis.serving import certify_example
from keystone_tpu_torch.analysis.specs import dtype_name, is_known, tree_leaves
from keystone_tpu_torch.ops import chain_kernels, kernels, meta
from keystone_tpu_torch.workflow.env import config_override

CHUNK = 256
MACHINE = (5e10, 2e10)
FLOP_RTOL = 0.05
BOUND_RTOL = 0.05


@pytest.fixture
def one_device_mesh():
    with use_mesh(make_mesh(jax.devices()[:1])) as mesh:
        yield mesh


@pytest.fixture(autouse=True)
def _chunk():
    with jax_config(chunk_size=CHUNK), config_override(chunk_size=CHUNK):
        yield


def _leaf_key(shape, name):
    kind = "int" if name.startswith(("int", "uint")) else name
    return tuple(int(s) for s in shape), kind


def _jax_elem(elem):
    return [_leaf_key(l.shape, np.dtype(l.dtype).name)
            for l in jax.tree_util.tree_leaves(elem)]


def _port_elem(elem):
    return [_leaf_key(l.shape, dtype_name(l.dtype)) for l in tree_leaves(elem)]


def _both(name):
    jp, js = jax_build(name)
    tp, ts = build_example(name, device="cpu")
    jspecs, _ = jax_spec_pass(jp.graph, {jp.source: jax_source_spec(js)})
    tspecs, _ = spec_pass(tp.graph, {tp.source: as_source_spec(ts)})
    return (jp, jspecs), (tp, tspecs)


def _by_id(d):
    return {(type(v).__name__, v.id): x for v, x in d.items()}


def test_the_registries_name_the_same_examples():
    assert list(EXAMPLES) == list(JAX_EXAMPLES)


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_spec_pass_matches_jax(name, one_device_mesh):
    (jp, jspecs), (tp, tspecs) = _both(name)
    jax_by, port_by = _by_id(jspecs), _by_id(tspecs)
    assert set(jax_by) == set(port_by)
    for key, a in jax_by.items():
        b = port_by[key]
        if key[0] == "NodeId":
            vid = next(v for v in jp.graph.operators if v.id == key[1])
            tvid = next(v for v in tp.graph.operators if v.id == key[1])
            assert jp.graph.get_operator(vid).label == \
                tp.graph.get_operator(tvid).label
        assert type(a).__name__ == type(b).__name__, key
        if type(a).__name__ != "DataSpec":
            continue
        assert (a.kind, a.count) == (b.kind, b.count), key
        assert jax_known(a.element) == is_known(b.element), key
        if is_known(b.element):
            assert _jax_elem(a.element) == _port_elem(b.element), key


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_memory_pass_peak_matches_jax(name, one_device_mesh):
    (jp, jspecs), (tp, tspecs) = _both(name)
    jm, _ = jax_memory_pass(jp.graph, jspecs, chunk_rows=CHUNK)
    tm, _ = memory_pass(tp.graph, tspecs, chunk_rows=CHUNK)
    assert tm.peak_bytes == jm.peak_bytes
    assert tm.unknown_nodes == jm.unknown_nodes


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_roofline_pass_matches_jax(name, one_device_mesh):
    (jp, jspecs), (tp, tspecs) = _both(name)
    jr, jd = jax_roofline(jp.graph, jspecs, machine=JaxMachine(*MACHINE),
                          chunk_rows=CHUNK)
    tr, td = roofline_pass(tp.graph, tspecs, machine=Machine(*MACHINE),
                           chunk_rows=CHUNK)
    jst = {v.id: s for v, s in jr.stages.items()}
    tst = {v.id: s for v, s in tr.stages.items()}
    assert set(jst) == set(tst)
    for vid, a in jst.items():
        b = tst[vid]
        assert a.label == b.label and a.bound == b.bound, a.label
        assert b.flops == pytest.approx(a.flops, rel=FLOP_RTOL), a.label
        if a.label != "MaxClassifier":
            assert b.hbm_bytes == a.hbm_bytes, a.label
    assert sorted(d.rule for d in td) == sorted(d.rule for d in jd)


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_serving_certificate_matches_jax(name, one_device_mesh):
    jc, jd = jax_certify(name)
    tc, td = certify_example(name, machine=Machine(*MACHINE), device="cpu")
    assert tc.certified == jc.certified
    assert sorted((d.rule, int(d.severity), d.label) for d in td) == \
        sorted((d.rule, int(d.severity), d.label) for d in jd)
    assert [s["batch"] for s in tc.shapes] == [s["batch"] for s in jc.shapes]
    for a, b in zip(jc.shapes, tc.shapes):
        assert b["predicted_seconds"] == pytest.approx(
            a["predicted_seconds"], rel=BOUND_RTOL)
    assert [(e["label"], e["counts"]) for e in tc.manifest] == \
        [(e["label"], e["counts"]) for e in jc.manifest]
    assert tc.dominating_stage == jc.dominating_stage
    assert tc.exposed_stages == jc.exposed_stages
    assert (tc.programs, tc.priced_stages, tc.unpriced_stages) == \
        (jc.programs, jc.priced_stages, jc.unpriced_stages)


def test_card_verdicts_are_the_ones_chip_smoke_checks(monkeypatch):
    """Under the card's calibration (the committed cuda_calibration.json)
    the port's verdicts and KP9xx findings are the table `chip_smoke.py`
    holds the card's certificates to."""
    import chip_smoke

    from keystone_tpu_torch.analysis import default_machine

    monkeypatch.setenv("KEYSTONE_COST_CALIBRATION", "force")
    machine = default_machine()
    assert machine.peak_flops > 1e13  # the card's rates, not the CPU's
    for name in EXAMPLES:
        cert, diags = certify_example(name, machine=machine, device="cpu")
        rules = sorted({(d.rule, d.severity.name) for d in diags
                        if d.rule.startswith("KP9")})
        assert (cert.certified, [list(r) for r in rules]) == \
            chip_smoke.SERVING_CARD_VERDICTS[name], name


def test_kernel_wrappers_meta_branch_computes_nothing():
    """A meta tensor reaches each wrapper's meta branch: an empty meta
    output, no launch counted, the kernel's work reported. A CPU tensor
    still reaches the plain version."""
    torch.manual_seed(0)
    x = torch.rand(2, 32, 32, 3)
    g = torch.randn(108, 8)
    colsum, bias = torch.randn(8), torch.randn(8)
    args = (g, colsum, bias, 0.25, 0.0, 14, 13, True, 6)
    kernels.reset_launches()
    with meta.collect_costs() as costs:
        y = kernels.conv_rectify_pool(x.to("meta"), *args)
        r = kernels.rectify_pool(torch.empty(2, 27, 27, 8, device="meta"),
                                 0.25, 0.0, 14, 13)
        k = kernels.rbf_block(torch.empty(5, 4, device="meta"),
                              torch.empty(3, 4, device="meta"), 0.5)
        fn = chain_kernels.build_chain_fn(
            [("PixelScaler",), ("GrayScaler",)], [(), ()])
        c = fn(torch.empty(4, 6, 6, 3, device="meta"))
    assert [t.device.type for t in (y, r, k, c)] == ["meta"] * 4
    assert tuple(y.shape) == (2, 2, 2, 16) and tuple(r.shape) == (2, 2, 2, 16)
    assert tuple(k.shape) == (5, 3) and tuple(c.shape) == (4, 6, 6, 1)
    assert costs.calls == {"conv_rectify_pool": 1, "rectify_pool": 1,
                           "rbf_block": 1, "elementwise_chain": 1}
    # K1's FLOPs: the 27x27 positions the pool windows cover, 108 x 8
    assert costs.flops >= 2.0 * 2 * 27 * 27 * 108 * 8
    assert fn.plans == {}  # no launch plan built for a meta tensor
    assert all(w.launches == 0 for w in (
        kernels.conv_rectify_pool, kernels.rectify_pool, kernels.rbf_block,
        chain_kernels.elementwise_chain))
    # a CPU tensor: the plain version, with values
    want = kernels.conv_rectify_pool_reference(
        x, kernels.cmajor_to_hwio(g, 6), colsum, bias, 0.25, 0.0, 14, 13,
        True)
    got = kernels.conv_rectify_pool(x, *args)
    assert got.device.type == "cpu"
    torch.testing.assert_close(got, want)
    assert kernels.conv_rectify_pool.launches == 0


def test_host_stages_are_unknown_device_stages_known():
    """KP901's ground: a body that needs values (``.item()``, ``.cpu()``)
    cannot run on meta tensors, and its spec is UNKNOWN; a shape error is
    a `SpecMismatchError`."""
    from keystone_tpu_torch.analysis.specs import (
        UNKNOWN,
        SpecMismatchError,
        shape_struct,
        trace_element,
    )

    elem = shape_struct((4, 8), torch.float32)
    w = torch.randn(8, 3)
    assert trace_element(lambda x: x @ w, [elem]) == shape_struct(
        (4, 3), torch.float32)
    assert trace_element(lambda x: float(x.sum().item()), [elem]) is UNKNOWN
    assert trace_element(lambda x: x.cpu().numpy(), [elem]) is UNKNOWN
    with pytest.raises(SpecMismatchError):
        trace_element(lambda x: x @ torch.randn(7, 3), [elem])
    assert isinstance(DataSpec(element=elem, count=2).nbytes, int)
