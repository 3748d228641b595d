"""The other five LM configs' training (granite-20b, stablelm-12b,
codeqwen1.5-7b, llama4-maverick, jamba-1.5-large) against the JAX
package's train step on the CPU, as `test_torch_train.py` holds the first
five: the same reference run (`reference_run`), the same tests and the
same limits, over another set of reduced configs.  A file of its own so
that each file keeps to a few minutes under xdist's `--dist loadfile`.

What these configs bring to the train path: granite's ungated GELU MLP on
one KV head (the reduced config keeps 4 query heads on it), stablelm's
head size of 160, codeqwen's full multi-head attention at θ 1e6, llama4's
top-1 MoE with a shared expert beside a dense layer (its router's
gradient through the output is rounding in both packages: see
`test_torch_train.test_step0_loss_and_every_gradient_leaf_match_the_reference`),
and jamba's period-8 hybrid group (seven Mamba2 layers, one attention
layer, a top-2 MoE on every other layer), rematerialised as one group.
"""
import pytest

from repro_torch import configs
from test_torch_train import (  # noqa: F401  (fixtures and tests shared with this module)
    _one_thread,
    chip_smoke,
    reference_run,
    test_microbatches_match_one_batch,
    test_remat_is_bitwise_the_plain_forward,
    test_step0_loss_and_every_gradient_leaf_match_the_reference,
    test_three_train_steps_match_the_reference,
    wrapper_calls,
)

#: the reduced configs trained here, with the overrides of the card's
#: reduced check (`chip_smoke.SERVE_REDUCED`): llama4 and jamba group their
#: KV heads (40 over 8 and 64 over 8 at full width), stablelm keeps its
#: head size of 160
MORE_TRAIN_CFGS = {"granite_20b": {}, "stablelm_12b": dict(n_kv_heads=2, head_dim=160),
                   "codeqwen15_7b": {}, "llama4_maverick_400b_a17b": dict(n_kv_heads=2),
                   "jamba_15_large_398b": dict(n_kv_heads=2)}


@pytest.fixture(scope="module", params=list(MORE_TRAIN_CFGS))
def trained(request, chip_smoke):  # noqa: F811
    """`reference_run` of each config of MORE_TRAIN_CFGS."""
    return reference_run(request.param, MORE_TRAIN_CFGS[request.param], chip_smoke,
                         control=True)


#: the configs whose reference, run again from its weights perturbed by
#: `CONTROL_PERTURBATION`, moves its own embedding by more than the fixed
#: 1e-3·max|ref| after three AdamW steps
SELF_DRIFT = ("codeqwen15_7b", "jamba_15_large_398b")


def test_the_references_own_drift_passes_the_fixed_limit(trained):
    """Why these configs' final weights are held to a control: the
    reference itself, from weights perturbed at float32's unit roundoff,
    moves codeqwen's and jamba's embedding past 1e-3·max|ref| (AdamW's
    first steps move a weight whose gradient sits at rounding level by
    ±lr)."""
    drift = trained["final_control"]["embed"]
    if trained["arch"] in SELF_DRIFT:
        assert drift > 1e-3, drift


def test_overrides_are_the_cards_reduced_check(chip_smoke):  # noqa: F811
    """The configs trained here are the ones the card's train phase holds
    against the CPU, with the same overrides."""
    for arch, overrides in MORE_TRAIN_CFGS.items():
        assert chip_smoke.SERVE_REDUCED[arch] == overrides


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", list(MORE_TRAIN_CFGS))
def test_kernel_calls_of_a_train_step(arch, remat, monkeypatch, chip_smoke):  # noqa: F811
    """`chip_smoke.train_launches` against the wrappers' calls over one
    gradient (as `test_torch_train.py`'s test of the same name): jamba's
    group runs kernel 6 seven times and kernel 5 once a forward."""
    cfg = configs.get_config(arch).reduced(**MORE_TRAIN_CFGS[arch])
    calls = wrapper_calls(cfg, remat, monkeypatch, chip_smoke)
    assert calls == chip_smoke.train_launches(cfg, remat)
    assert any(calls.values())


#: the full-width cuts of chip_smoke.py's new cells: (arch, layers, their
#: parameters, their layers' mixer + FFN, kernel 5 / 5b / 6 / 6b calls a
#: train step with remat)
CUT_CELLS = (("granite_20b", 18, 7_427_291_136, ["attn+mlp"] * 18, (36, 18, 0, 0)),
             ("stablelm_12b", 22, 7_141_032_960, ["attn+mlp"] * 22, (44, 22, 0, 0)),
             ("codeqwen15_7b", 28, 7_260_573_696, ["attn+mlp"] * 28, (56, 28, 0, 0)),
             ("jamba_15_large_398b", (0, 4), 2_839_668_480, ["mamba+mlp", "attn+mlp"],
              (2, 1, 2, 1)))


@pytest.mark.parametrize("arch,layers,params,specs,calls", CUT_CELLS,
                         ids=[c[0] for c in CUT_CELLS])
def test_train_cells_cut_in_depth_only(arch, layers, params, specs, calls,
                                       chip_smoke):  # noqa: F811
    """`chip_smoke.cut_layers` keeps every width and cuts depth only, as
    `TRAIN_CELLS` names it: a layer count, or layers of the group by index
    (jamba's Mamba2 + MLP and attention + MLP layers, as one group)."""
    from repro_torch.models import analysis

    assert (arch, "train_4k_b1", layers) in {c[:3] for c in chip_smoke.TRAIN_CELLS}
    full = configs.get_config(arch)
    cfg = chip_smoke.cut_layers(full, layers)
    for name in ("d_model", "n_heads", "n_kv_heads", "d_ff", "vocab_size", "head_dim", "moe",
                 "ssm"):
        assert getattr(cfg, name) == getattr(full, name)
    assert [f"{sp.mixer}+{sp.ffn}" for sp in cfg.layer_specs()] == specs
    assert analysis.param_count(cfg) == params
    assert tuple(chip_smoke.train_launches(cfg, remat=True).values()) == calls


def test_jamba_serve_cell_is_the_groups_first_five_layers(chip_smoke):  # noqa: F811
    """jamba-1.5-large serves at full width cut to the first five layers of
    its group of 8 (23.99 B parameters): kernel 5 once and kernel 6 four
    times a prefill.  A count that is neither whole groups nor part of one
    is refused."""
    from repro_torch.models import analysis

    cell = next(c for c in chip_smoke.SERVE_CELLS if c[0] == "jamba_15_large_398b")
    assert cell[1:] == ("decode_4k_b4", 4, 5) and not chip_smoke.REDUCED_ONLY
    full = configs.get_config("jamba_15_large_398b")
    cfg = chip_smoke.cut_layers(full, 5)
    assert cfg.group == full.group[:5] and cfg.n_layers == 5
    assert analysis.param_count(cfg) == 23_992_105_984
    assert chip_smoke.lm_launches(cfg) == {"flash_attention": 1, "ssd_scan": 4}
    with pytest.raises(ValueError, match="neither whole groups"):
        chip_smoke.cut_layers(full, 12)
    assert chip_smoke.cut_layers(full, 16).group == full.group
