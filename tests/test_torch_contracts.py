"""The port's operator contract auditor (KP5xx,
`keystone_tpu_torch/analysis/contracts.py`) and effect analyzer (KP511)
on the CPU.

Mirrors the 32 tests of `tests/test_contracts.py` with the port's
stages. Where a JAX test stage carries its fused function in ``fuse()``
(``(key, params, fn)``), the port's stage carries its batch function in
``batch_fn`` and ``fuse()`` returns ``(key, params)``, as the port's
fusion builder takes it. Differences by design:

- KP502 runs the batch function on meta tensors where JAX uses
  ``jax.eval_shape``;
- KP503: torch has no ``donate_argnums`` and the port recognizes no
  donation mechanism, so every declared ``donates_deps`` fires, JAX's
  "honest donor" (a step jitted with ``donate_argnums``) included. No
  operator of either package declares one, so the registry audits agree;
- ANALYSIS.md's catalog and ``scripts/jaxlint.py`` are the JAX
  package's: the doc-sync case checks the port's rule table against
  JAX's, and the linter case checks the port's rule ids against the
  CLI's ``--list-rules``.

The registry audit's counts per rule equal JAX's (none) over the
operator classes the two packages share, and the CLI's ``--audit-operators
--json`` reports no finding.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from keystone_tpu.analysis.contracts import (
    audit_class as jax_audit_class,
    audit_registry as jax_audit_registry,
    operator_registry as jax_operator_registry,
)
from keystone_tpu.analysis.diagnostics import RULES as JAX_RULES
from keystone_tpu_torch.analysis import Severity
from keystone_tpu_torch.analysis.contracts import (
    audit_class,
    audit_operator,
    audit_registry,
    operator_registry,
)
from keystone_tpu_torch.analysis.diagnostics import RULES
from keystone_tpu_torch.analysis.effects import (
    class_effects,
    interference_pass,
    operator_effects,
)
from keystone_tpu_torch.analysis.specs import SpecDataset
from keystone_tpu_torch.nodes.stats.random_features import RandomSignNode
from keystone_tpu_torch.workflow.env import dispatch_override
from keystone_tpu_torch.workflow.pipeline import (
    Estimator,
    Pipeline,
    Transformer,
)

REPO = Path(__file__).resolve().parent.parent


# --------------------------------------------------------------- helpers


class _CleanStage(Transformer):
    """Fusable and chunkable with a structural fuse(): contract-clean."""

    fusable = True
    chunkable = True

    def batch_fn(self):
        return lambda xb: xb * 2.0

    def fuse(self):
        return ("CleanStage",), ()


class _NoFuseStage(Transformer):
    """Declares fusable, implements no fuse()."""

    fusable = True

    def batch_fn(self):
        return lambda xb: xb * 2.0


class _StrippedRandomSign(RandomSignNode):
    """A real stats stage with its fuse() stripped off."""

    fuse = None


class _GramStage(Transformer):
    """chunkable declared, but the batch path is a whole-batch Gram."""

    chunkable = True

    def batch_fn(self):
        return lambda xb: xb @ xb.T

    def fuse(self):
        return ("Gram",), ()


class _BatchMeanStage(Transformer):
    """chunkable declared, but the batch path reduces over the rows."""

    chunkable = True

    def batch_fn(self):
        return lambda xb: torch.mean(xb, dim=0)


class _Donor(Transformer):
    donates_deps = (0,)

    def batch_fn(self):
        return lambda xb: xb.add_(1.0)


class _SubclassedDonor(_Donor):
    """Empty body: donates_deps resolves through the MRO."""


class _UnmaskedMasker(Transformer):
    """Masks padded rows in the unfused batch path but does not declare
    fuse_masks_output."""

    fusable = True

    def batch_fn(self):
        return lambda xb: xb

    def fuse(self):
        return ("UnmaskedMasker",), ()

    def apply_batch(self, data):
        return data.with_data(data.array * data.mask[:, None])


class _DeclaredMasker(_UnmaskedMasker):
    fuse_masks_output = True


class _SubclassedMasker(_UnmaskedMasker):
    """Empty body: the masking batch path is inherited."""


class _SuppressedNoFuse(Transformer):  # keystone: ignore[KP501]
    """A genuine exception, suppressed on the class line."""

    fusable = True

    def batch_fn(self):
        return lambda xb: xb


class _StatefulEstimator(Estimator):
    """fusable_fit promising a fit whose transformer is opaque."""

    fusable_fit = True

    def fit(self, data):
        return _NoFuseStage()


class _CleanEstimator(Estimator):
    fusable_fit = True

    def fit(self, data):
        return _CleanStage()


def _rules(diags):
    return sorted({d.rule for d in diags})


# ------------------------------------------------------ KP501 (fuse key)


def test_kp501_flags_fusable_without_fuse():
    diags = audit_operator(_NoFuseStage())
    assert _rules(diags) == ["KP501"]
    assert diags[0].severity == Severity.WARNING
    assert "fuse()" in diags[0].message


def test_kp501_negative_structural_fuse():
    assert audit_operator(_CleanStage(), [(6,)]) == []


def test_kp501_regression_stripped_stats_stage():
    assert audit_operator(RandomSignNode(6, device="cpu"), [(6,)]) == []
    diags = audit_operator(_StrippedRandomSign(6, device="cpu"))
    assert _rules(diags) == ["KP501"]


def test_kp501_detects_opaque_key_not_method_presence():
    class _OpaqueFuse(Transformer):
        fusable = True

        def batch_fn(self):
            return lambda xb: xb

        def fuse(self):
            return ("opaque", id(self)), ()

    diags = audit_operator(_OpaqueFuse())
    assert _rules(diags) == ["KP501"]
    assert "opaque" in diags[0].message


def test_kp501_via_fusable_fit_output():
    diags = audit_operator(_StatefulEstimator())
    assert _rules(diags) == ["KP501"]
    assert "_NoFuseStage" in diags[0].message
    assert audit_operator(_CleanEstimator()) == []


def test_kp501_suppressed_on_class_line():
    assert audit_operator(_SuppressedNoFuse()) == []


# -------------------------------------------------- KP502 (distributivity)


def test_kp502_flags_non_distributive_batch_path():
    diags = audit_operator(_GramStage(), [(4,)])
    assert _rules(diags) == ["KP502"]
    assert diags[0].severity == Severity.ERROR
    assert _rules(audit_operator(_BatchMeanStage(), [(4,)])) == ["KP502"]


def test_kp502_negative_distributive_and_host_stages():
    from keystone_tpu_torch.nodes.stats.normalization import (
        ColumnSampler,
        NormalizeRows,
    )

    assert audit_operator(NormalizeRows(), [(6,)]) == []
    # a host-code batch path is not provable either way: never flagged
    assert audit_operator(ColumnSampler(4), [(8, 6)]) == []


# ------------------------------------------------------ KP503 (donation)


def test_kp503_flags_every_declared_donation():
    diags = audit_operator(_Donor())
    assert _rules(diags) == ["KP503"]
    assert "donate_argnums" in diags[0].message
    assert diags[0].severity == Severity.WARNING


def test_kp503_resolves_through_mro():
    assert _rules(audit_operator(_SubclassedDonor())) == ["KP503"]


def test_kp503_negative_without_donation():
    assert audit_operator(_CleanStage(), [(6,)]) == []
    assert not [c for c in operator_registry()
                if getattr(c, "donates_deps", ())]


# -------------------------------------------------------- KP504 (masking)


def test_kp504_flags_unmasked_fused_stage():
    diags = audit_operator(_UnmaskedMasker())
    assert _rules(diags) == ["KP504"]
    assert diags[0].severity == Severity.ERROR
    assert "fuse_masks_output" in diags[0].message


def test_kp504_sees_inherited_masking_batch_path():
    assert _rules(audit_operator(_SubclassedMasker())) == ["KP504"]


def test_kp504_negative_declared_and_mask_aware():
    from keystone_tpu_torch.nodes.stats.scalers import StandardScalerModel
    from keystone_tpu_torch.nodes.util.fusion import FusedBatchTransformer

    assert audit_operator(_DeclaredMasker()) == []
    assert audit_operator(StandardScalerModel(torch.zeros(4),
                                              torch.ones(4))) == []
    assert audit_operator(FusedBatchTransformer([_CleanStage()])) == []


# -------------------------------------------------- registry-wide sweep


def test_registry_audit_is_clean():
    findings, stats = audit_registry()
    assert not findings, "\n".join(
        f"{cls.__qualname__}: {d}" for cls, d in findings)
    assert stats["classes"] > 80
    assert stats["probed"] > 40


def test_registry_counts_per_rule_equal_jax_s():
    """Over the operator classes both packages define (by name), the
    registry audits find the same rules the same number of times."""
    def per_rule(findings, shared):
        out = {}
        for cls, d in findings:
            if cls.__qualname__ in shared:
                out[d.rule] = out.get(d.rule, 0) + 1
        return out

    port_names = {c.__qualname__ for c in operator_registry()}
    jax_names = {c.__qualname__ for c in jax_operator_registry()}
    shared = port_names & jax_names
    assert len(shared) > 60
    port_findings, _ = audit_registry()
    jax_findings, _ = jax_audit_registry()
    assert per_rule(port_findings, shared) == per_rule(jax_findings, shared)
    # class by class over the shared probe table, the probe status agrees
    by_name = {c.__qualname__: c for c in operator_registry()}
    jax_by_name = {c.__qualname__: c for c in jax_operator_registry()}
    for name in ("RandomSignNode", "StandardScalerModel", "Convolver",
                 "Pooler", "FusedBatchTransformer", "LinearMapper"):
        got, got_probed = audit_class(by_name[name])
        want, want_probed = jax_audit_class(jax_by_name[name])
        assert (_rules(got), got_probed) == (_rules(want), want_probed)


def test_registry_discovers_node_and_fusion_classes():
    names = {c.__name__ for c in operator_registry()}
    assert {"RandomSignNode", "StandardScalerModel", "FusedBatchTransformer",
            "MegafusedBatchTransformer", "LinearMapper",
            "GrayScaler"} <= names
    assert all(c.__module__.startswith("keystone_tpu_torch.")
               for c in operator_registry())


def test_audit_class_reports_probe_status():
    diags, probed = audit_class(RandomSignNode)
    assert diags == [] and probed
    from keystone_tpu_torch.workflow.operators import DelegatingOperator

    diags, _ = audit_class(DelegatingOperator)
    assert diags == []


# ---------------------------------------------- validate() integration


def test_validate_full_surfaces_kp501():
    pipe = _StrippedRandomSign(6, device="cpu").to_pipeline()
    report = pipe.validate((6,), raise_on_error=False)
    assert report.by_rule("KP501"), str(report)
    assert not pipe.validate(
        (6,), ignore=["KP501"], raise_on_error=False).by_rule("KP501")


def test_validate_full_surfaces_kp502_as_error():
    report = _GramStage().to_pipeline().validate((4,), raise_on_error=False)
    kp502 = report.by_rule("KP502")
    assert kp502 and kp502[0].severity == Severity.ERROR


def test_validate_structure_tier_skips_contracts():
    pipe = _StrippedRandomSign(6, device="cpu").to_pipeline()
    report = pipe.validate((6,), level="structure", raise_on_error=False)
    assert not report.by_rule("KP501")


# ------------------------------------------------- effects + KP511


class _EffectfulCounter(Transformer):
    """Deliberately effectful: mutates instance state at apply time."""

    chunkable = True

    def __init__(self):
        self.calls = 0

    def apply(self, x):
        self.calls = self.calls + 1
        return x


class _MemoizedStage(Transformer):
    """The sanctioned instance-memo idiom: not an effect."""

    def apply(self, x):
        got = self.__dict__.get("_memo")
        if got is None:
            self.__dict__["_memo"] = got = 2.0
        return x * got


class _SuppressedEffect(Transformer):
    def apply(self, x):
        self.last = x  # keystone: ignore[KP511]
        return x


class _MutatorCounter(Transformer):
    chunkable = True

    def __init__(self):
        self.seen = []

    def apply(self, x):
        self.seen.append(x)
        return x


class _DictMemoMutator(Transformer):
    def apply(self, x):
        self.__dict__.setdefault("_hits", []).append(1)
        return x


def _effectful_gather_pipeline(shared):
    left = shared.to_pipeline() >> Transformer.from_function(
        lambda x: x + 1.0, name="L")
    right = shared.to_pipeline() >> Transformer.from_function(
        lambda x: x - 1.0, name="R")
    return Pipeline.gather([left, right])


def test_effect_inference_finds_self_writes():
    effects = class_effects(_EffectfulCounter)
    assert any(e.kind == "self_write" and e.target == "attr:calls"
               for e in effects)
    assert class_effects(_MemoizedStage) == ()
    assert class_effects(_SuppressedEffect) == ()
    assert class_effects(_CleanStage) == ()


def test_effect_inference_finds_self_container_mutators():
    effects = class_effects(_MutatorCounter)
    assert any(e.kind == "self_write" and e.target == "attr:seen"
               for e in effects)
    assert class_effects(_DictMemoMutator) == ()
    diags = interference_pass(_effectful_gather_pipeline(
        _MutatorCounter()).apply(SpecDataset((4,), count=8)).graph)
    assert diags and all(d.rule == "KP511" for d in diags)


def test_operator_effects_sees_composite_components():
    from keystone_tpu_torch.nodes.util.fusion import FusedBatchTransformer

    inner = _EffectfulCounter()
    assert id(inner) in operator_effects(FusedBatchTransformer([inner]))


def test_kp511_true_positive_under_concurrent_scheduler():
    pipe = _effectful_gather_pipeline(_EffectfulCounter())
    with dispatch_override(True, workers=4):
        report = pipe.validate((4,), raise_on_error=False)
    kp511 = report.by_rule("KP511")
    assert kp511, str(report)
    assert kp511[0].severity == Severity.WARNING
    assert "simultaneously" in kp511[0].message


def test_kp511_true_negative_with_scheduler_off():
    pipe = _effectful_gather_pipeline(_EffectfulCounter())
    with dispatch_override(False):
        report = pipe.validate((4,), raise_on_error=False)
    assert not report.by_rule("KP511"), str(report)


def test_kp511_ordered_chain_does_not_fire():
    shared = _EffectfulCounter()
    pipe = shared.to_pipeline() >> Transformer.from_function(
        lambda x: x * 2.0, name="mid") >> shared
    with dispatch_override(True, workers=4):
        report = pipe.validate((4,), raise_on_error=False)
    assert not report.by_rule("KP511"), str(report)


def test_kp511_distinct_instances_do_not_fire():
    pipe = Pipeline.gather([_EffectfulCounter().to_pipeline(),
                            _EffectfulCounter().to_pipeline()])
    with dispatch_override(True, workers=4):
        report = pipe.validate((4,), raise_on_error=False)
    assert not report.by_rule("KP511"), str(report)


def test_concurrent_relation_matches_dag_order():
    from keystone_tpu_torch.workflow.analysis import children
    from keystone_tpu_torch.workflow.executor import concurrent_relation

    shared = _EffectfulCounter()
    g = _effectful_gather_pipeline(shared).apply(
        SpecDataset((4,), count=8)).graph
    unordered = concurrent_relation(g)
    heads = [n for n in g.operators if g.get_operator(n) is shared]
    assert len(heads) == 2
    assert unordered(heads[0], heads[1])
    kid = next(iter(children(g, heads[0])))
    assert not unordered(heads[0], kid)


def test_interference_pass_direct():
    g = _effectful_gather_pipeline(_EffectfulCounter()).apply(
        SpecDataset((4,), count=8)).graph
    diags = interference_pass(g)
    assert diags and all(d.rule == "KP511" for d in diags)


# ------------------------------------------------------------- doc sync


def test_rule_table_is_jax_s_less_the_unported_tiers():
    """Every rule the port emits is one of JAX's; JAX's rules the port
    lacks are the Mosaic kernel proofs (KP10xx); the KP5xx texts are
    JAX's."""
    assert set(RULES) <= set(JAX_RULES)
    missing = set(JAX_RULES) - set(RULES)
    assert missing == {r for r in JAX_RULES
                       if r.startswith("KP10") and len(r) == 6}
    for rule in ("KP501", "KP502", "KP503", "KP504"):
        assert RULES[rule] == JAX_RULES[rule]


# ------------------------------------------------------------------ CLI


def test_audit_cli_json_output():
    out = subprocess.run(
        [sys.executable, "-m", "keystone_tpu_torch.analysis",
         "--audit-operators", "--json"],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    payload = json.loads(out.stdout)
    assert payload["findings"] == []
    assert payload["audited_classes"] > 80


def test_list_rules_cli_names_every_rule():
    out = subprocess.run(
        [sys.executable, "-m", "keystone_tpu_torch.analysis",
         "--list-rules"], capture_output=True, text=True, cwd=REPO,
        timeout=300)
    assert out.returncode == 0, out.stderr
    listed = [line.split()[0] for line in out.stdout.splitlines() if line]
    assert listed == sorted(RULES)
