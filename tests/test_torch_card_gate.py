"""The card gate's end-to-end rule on the CPU (``chip_smoke.serving``).

The end-to-end gates of phases 3, 7 and 19 are data (``e2e_bf16``,
``e2e_tiled``, ``e2e_tiled_partial``, ``e2e_f32``) that one routine runs on
the card and holds to ``e2e_rule``. Each case below is one comparison a
gate makes, with its limit: a kernel path no further from an f32 plain run
than BF16_SLACK (1.1) x the plain bf16 path is, the tiled f32 plain run
within TILED_Z_GATE (1e-4) / TILED_RECON_GATE (1e-3) of the non-tiled one,
the f32 kernel path within F32_E2E_GATE (2e-4) of the plain f32 path, and
FSQ's index flips (FLIP_RULE). A reading at its limit passes; one just
past it raises, naming the reading. Every rule of every gate is a case.
"""

import math

import pytest

import chip_smoke as cs
from chip_smoke import serving as sv

SLACK, TILED_Z, TILED_RECON, F32_E2E = 1.1, 1e-4, 1e-3, 2e-4


def gates() -> dict:
    fsq = sv.e2e_bf16(cs.REQUEST, "v1_0")
    return {"bf16": sv.e2e_bf16(cs.REQUEST, "v1_0"),
            "bf16_partial": sv.e2e_bf16(cs.PARTIAL_REQUEST, "v1_0"),
            "bf16_forms": sv.e2e_bf16(cs.REQUEST, "v1_0", ("v1_0_forms", "v1_0_split")),
            "fsq_options": fsq._replace(rules=fsq.rules + (sv.FLIP_RULE,)),
            "tiled": sv.e2e_tiled(cs.TILED_REQUEST),
            "tiled_partial": sv.e2e_tiled_partial(),
            "f32": sv.e2e_f32(cs.REQUEST, cs.PER_FORWARD["v1_0"], "v1.0"),
            "f32_forms": sv.e2e_f32(cs.TILED_REQUEST, cs.tiled_per_forward(65), "tiled",
                                    "tiled_forms", True)}


def slack(key, ref, whats=("z", "recon")):
    return [(f"{w}_{key}_vs_{ref}", SLACK, f"{w}_plain_vs_{ref}") for w in whats]


CASES = {
    "bf16": slack("kernel", "f32"),
    "bf16_partial": slack("kernel", "f32"),
    "bf16_forms": slack("v1_0_forms", "f32") + slack("v1_0_split", "f32"),
    "fsq_options": slack("kernel", "f32")
    + [("indices_kernel_vs_f32", SLACK, "indices_plain_vs_f32")],
    "tiled": slack("kernel", "untiled_f32") + slack("kernel", "tiled_f32")
    + slack("tiled_forms", "tiled_f32")
    + [("z_tiled_f32_vs_untiled_f32", TILED_Z, None),
       ("recon_tiled_f32_vs_untiled_f32", TILED_RECON, None)],
    "tiled_partial": slack("kernel", "tiled_f32"),
    "f32": [("z_kernel_f32_vs_plain_f32", F32_E2E, None),
            ("recon_kernel_f32_vs_plain_f32", F32_E2E, None)],
    "f32_forms": [("z_kernel_f32_vs_plain_f32", F32_E2E, None),
                  ("recon_kernel_f32_vs_plain_f32", F32_E2E, None)],
}


def test_limits_and_rules():
    """The limits are the card gate's, and each gate holds exactly the
    comparisons listed in CASES."""
    assert (cs.BF16_SLACK, cs.TILED_Z_GATE, cs.TILED_RECON_GATE, cs.F32_E2E_GATE) == (
        SLACK, TILED_Z, TILED_RECON, F32_E2E)
    got = gates()
    assert got.keys() == CASES.keys()
    for name, gate in got.items():
        assert sorted(gate.rules, key=str) == sorted(CASES[name], key=str), name


def passing(rules) -> dict:
    """Readings that pass every rule: bases 0.02, slack readings 0.01, fixed
    limits' readings a tenth of the limit."""
    res = {}
    for reading, limit, base in rules:
        if base is None:
            res[reading] = limit / 10
        else:
            res[reading], res[base] = 0.01, 0.02
    return res


@pytest.mark.parametrize("name,rule", [(n, r) for n, rules in CASES.items() for r in rules],
                         ids=lambda v: v if isinstance(v, str) else v[0])
def test_rule_at_and_past_its_limit(name, rule):
    gate = gates()[name]
    reading, limit, base = rule
    res = passing(gate.rules)
    bound = limit if base is None else limit * res[base]
    res[reading] = bound
    sv.e2e_rule(res, gate.rules, gate.label)
    res[reading] = math.nextafter(bound, math.inf)
    with pytest.raises(AssertionError, match=reading):
        sv.e2e_rule(res, gate.rules, gate.label)


def test_readings_name_the_pairs():
    """``e2e_readings`` reads each pair of runs on z and the reconstruction,
    and FSQ indices only where the runs gave them."""
    import torch

    gate = gates()["fsq_options"]
    z, rec = torch.ones(2, 3), torch.ones(4)
    outs = {r.key: (z * (1 + i), rec, torch.tensor([0, i, 1, 1]))
            for i, r in enumerate(gate.runs)}
    res = sv.e2e_readings(outs, gate.pairs, gate.index_pairs)
    assert list(res) == ["z_kernel_vs_plain", "z_kernel_vs_f32", "z_plain_vs_f32",
                         "recon_kernel_vs_plain", "recon_kernel_vs_f32",
                         "recon_plain_vs_f32", "indices_kernel_vs_f32",
                         "indices_plain_vs_f32"]
    assert res["z_kernel_vs_f32"] == pytest.approx(2 / 3)
    assert res["indices_kernel_vs_f32"] == 0.25 and res["indices_plain_vs_f32"] == 0.25
    outs = {k: v[:2] + (None,) for k, v in outs.items()}
    assert "indices_kernel_vs_f32" not in sv.e2e_readings(outs, gate.pairs, gate.index_pairs)
