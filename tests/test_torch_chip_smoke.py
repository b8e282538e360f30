"""chip_smoke.py's device-time yardstick on the CPU: ``device_trace`` (under
``device_ms``) profiles one call, then ``calls`` calls, and sums a trace
only when it holds ``calls`` times each kernel's records a call (the most
any window has shown, and at least the launches the port's wrappers
counted); otherwise it tries again, up to three times.  After three, a
trace that held every kernel gives each kernel its mean over the records
it holds times its records a call; where none did, it raises.  The
profiler is replaced by recorded rows, so no card is needed;
``_window_rows`` runs on the CPU's own events."""
import importlib.util
import pathlib
from types import SimpleNamespace

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def smoke(monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke_yardstick",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)
    return mod


def _profiler(smoke, monkeypatch, traces):
    """Run each profiled window's calls and hand out ``traces`` ({name:
    (count, us)}) in turn for them; return the windows' call counts as they
    are asked for."""
    asked = []

    def fake(fn, calls):
        asked.append(calls)
        for _ in range(calls):
            fn()
        return {k: SimpleNamespace(key=k, count=n, self_device_time_total=us)
                for k, (n, us) in traces[len(asked) - 1].items() if n}
    monkeypatch.setattr(smoke, "_device_rows", fake)
    return asked


ONE = {"prep": (1, 10.0), "kernel": (1, 90.0)}
FULL = {"prep": (10, 100.0), "kernel": (10, 900.0)}
# a trace that lost half the kernel's records: their mean is the same
SHORT = {"prep": (10, 100.0), "kernel": (5, 450.0)}
PREP_ONLY = {"prep": (10, 100.0)}


def test_a_whole_trace_is_summed_at_once(smoke, monkeypatch):
    asked = _profiler(smoke, monkeypatch, [ONE, FULL])
    assert smoke.device_ms(lambda: None, 10) == pytest.approx(0.1)
    assert asked == [1, 10]


def test_a_short_trace_is_taken_again(smoke, monkeypatch):
    asked = _profiler(smoke, monkeypatch, [ONE, SHORT, ONE, FULL])
    assert smoke.device_trace(lambda: None, 10) == {"prep": pytest.approx(0.01),
                                                    "kernel": pytest.approx(0.09)}
    assert asked == [1, 10, 1, 10]


def test_three_short_traces_give_the_fullest_ones_means_times_the_records_a_call(
        smoke, monkeypatch):
    """The sum of a short trace would read 0.055 ms a call; the means of
    the records the fullest holds, times one record a call each, read the
    0.1 ms a call of a whole trace."""
    shorter = {"prep": (4, 40.0), "kernel": (4, 360.0)}
    asked = _profiler(smoke, monkeypatch, [ONE, shorter, ONE, SHORT, ONE, shorter])
    assert smoke.device_ms(lambda: None, 10) == pytest.approx(0.1)
    assert asked == [1, 10] * 3


def test_the_records_a_call_come_from_a_one_call_window(smoke, monkeypatch):
    """A kernel launched twice a call whose traces lost more than ``calls``
    of its records: its count in the traces, rounded up, reads one record
    a call; the one-call window's two are taken."""
    one = {"prep": (1, 10.0), "kernel": (2, 180.0)}
    lossy = {"prep": (10, 100.0), "kernel": (9, 810.0)}
    _profiler(smoke, monkeypatch, [one, lossy] * 3)
    assert smoke.device_trace(lambda: None, 10) == {"prep": pytest.approx(0.01),
                                                    "kernel": pytest.approx(0.18)}


def test_a_trace_that_shows_more_records_a_call_raises_the_count(smoke, monkeypatch):
    """A one-call window that lost one of a kernel's two records: a whole
    trace of 20 shows two a call, and is summed."""
    asked = _profiler(smoke, monkeypatch, [ONE, {"prep": (10, 100.0), "kernel": (20, 1800.0)}])
    assert smoke.device_ms(lambda: None, 10) == pytest.approx(0.19)
    assert asked == [1, 10]


@pytest.mark.parametrize("warm_up", [{}, {"kernel": (1, 90.0)}])
def test_a_whole_trace_makes_up_for_a_lossy_one_call_window(smoke, monkeypatch, warm_up):
    asked = _profiler(smoke, monkeypatch, [warm_up, FULL])
    assert smoke.device_ms(lambda: None, 10) == pytest.approx(0.1)
    assert asked == [1, 10]


def test_a_kernel_missing_from_every_trace_raises(smoke, monkeypatch):
    _profiler(smoke, monkeypatch, [ONE, PREP_ONLY] * 3)
    with pytest.raises(RuntimeError, match="lost a kernel of the call"):
        smoke.device_ms(lambda: None, 10)


def test_a_second_round_follows_three_traces_that_lost_a_kernel(smoke, monkeypatch):
    """device_ms_twice: after a round of three traces that all lost the
    kernel (device_ms raises), one more round, summed where it is whole;
    two such rounds raise."""
    asked = _profiler(smoke, monkeypatch, [ONE, PREP_ONLY] * 3 + [ONE, FULL])
    assert smoke.device_ms_twice(lambda: None, 10) == pytest.approx(0.1)
    assert asked == [1, 10] * 4
    _profiler(smoke, monkeypatch, [ONE, PREP_ONLY] * 6)
    with pytest.raises(RuntimeError, match="lost a kernel of the call"):
        smoke.device_ms_twice(lambda: None, 10)


def test_the_wrappers_counters_outvote_windows_that_all_lost_a_kernel(smoke, monkeypatch):
    """Every window lost the wrapper's second kernel: the traces look whole
    for the one kernel they hold, but the wrappers counted two launches a
    call, so none is summed and the yardstick raises."""
    from fairygen_tpu_torch.ops import _kernels

    def call():
        _kernels.launches["flash_fwd_prep_f32"] += 1
        _kernels.launches["flash_fwd_lse_f32"] += 1

    _kernels.reset_launches()
    asked = _profiler(smoke, monkeypatch, [{"prep": (1, 10.0)}, PREP_ONLY] * 3)
    with pytest.raises(RuntimeError, match="2 launches counted"):
        smoke.device_ms(call, 10)
    assert asked == [1, 10] * 3
    _kernels.reset_launches()


def test_traces_without_device_time_raise(smoke, monkeypatch):
    idle = {"prep": (10, 0.0), "kernel": (10, 0.0)}
    _profiler(smoke, monkeypatch, [ONE, {}, ONE, idle, ONE, {}])
    with pytest.raises(RuntimeError, match="lost a kernel of the call"):
        smoke.device_ms(lambda: None, 10)


def test_a_trace_without_device_time_is_taken_again(smoke, monkeypatch):
    idle = {"prep": (10, 0.0), "kernel": (10, 0.0)}
    asked = _profiler(smoke, monkeypatch, [ONE, idle, ONE, FULL])
    assert smoke.device_ms(lambda: None, 10) == pytest.approx(0.1)
    assert asked == [1, 10, 1, 10]


def test_the_profiler_window_records_the_calls_not_its_spin(smoke, monkeypatch):
    """A window holds its calls' events and not its opening spin kernel's
    (CPU ops stand in for kernels)."""
    def spin(cycles):
        with torch.profiler.record_function("at::spin_kernel(long)"):
            torch.ones(1)

    monkeypatch.setattr(torch.cuda, "_sleep", spin)

    def fn():
        with torch.profiler.record_function("window_call"):
            torch.ones(3).add_(1)

    rows = smoke._window_rows(fn, 4, [torch.profiler.ProfilerActivity.CPU])
    assert sum(e.count for e in rows if e.key == "window_call") == 4
    assert not [e for e in rows if "spin" in e.key]


# ------------------------------------------------------- the variants phase
@pytest.mark.parametrize("clip,model_hash", [(False, "5b013604280dd715f8457c6ed6d6a626"),
                                             (True, "6bfcfb3b342cb286ce886889d519a77e")])
def test_the_14b_configs_are_the_registry_entries(smoke, clip, model_hash):
    """The variants phase's seeded DiTs have the fields the registry gives
    Wan2.2-I2V-A14B's experts and Wan2.1-I2V-14B."""
    import json

    entries = json.loads((REPO / "fairygen_tpu_torch" / "configs" /
                          "model_registry.json").read_text())
    extra = next(e["extra_kwargs"] for e in entries if e["model_hash"] == model_hash)
    cfg = smoke.wan14b_cfg(clip)
    for k, v in extra.items():
        assert getattr(cfg, k) == (tuple(v) if isinstance(v, list) else v), k
    assert cfg.require_clip_embedding == clip and cfg.require_vae_embedding


def test_vae_norm_silu_calls_counts_the_v1_sites(smoke, monkeypatch):
    """The K11 launches the phase expects of a Wan2.1 VAE pass are every
    norm + SiLU site of it, as in the VAE38: counted on the CPU through the
    name the VAE module calls, for a small v1 VAE over a 5-frame 32 x 32
    clip (21 and 29 at the published width)."""
    import numpy as np

    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.models.wan import vae as tvae

    cfg = tvae.WanVAEConfig.tiny_v1(dim_mult=(1, 2, 4, 4))
    params = convert.init_vae_params(cfg, "cpu", torch.float32, seed=0)
    calls = []
    shapes, undo = smoke.record_k11_shapes(tvae)
    x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (1, 3, 5, 32, 32))
                         .astype(np.float32))
    try:
        with torch.no_grad():
            z = tvae.vae38_encode(params, cfg, x)
            calls.append(sum(shapes.values()))
            tvae.vae38_decode(params, cfg, z)
            calls.append(sum(shapes.values()) - calls[0])
    finally:
        undo()
    assert tuple(calls) == smoke.vae_norm_silu_calls(cfg) and all(calls)
    assert smoke.vae_norm_silu_calls(tvae.WanVAEConfig.wan21_16()) == (21, 29)


def test_expert_sweeps_are_counted_per_expert(smoke):
    """count_expert_sweeps tells the two experts' sweeps apart (a tiny
    two-expert pipeline, 3 steps, boundary 0.9: 2 and 1 steps) and its undo
    puts the pipeline's DiT forward back."""
    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.models.wan.dit import WanDiTConfig
    from fairygen_tpu_torch.models.wan.vae import WanVAEConfig
    from fairygen_tpu_torch.pipelines import wan_video

    cfg = WanDiTConfig(dim=48, in_dim=12, ffn_dim=64, out_dim=4, text_dim=16, freq_dim=16,
                       num_heads=2, num_layers=1, require_clip_embedding=False)
    vcfg = WanVAEConfig.tiny_v1()
    pipe = wan_video.WanVideoPipeline(
        convert.init_dit_params(cfg, "cpu", torch.float32, seed=0), cfg,
        convert.init_vae_params(vcfg, "cpu", torch.float32, seed=1), vcfg, dtype=torch.float32,
        device="cpu", dit2_params=convert.init_dit_params(cfg, "cpu", torch.float32, seed=2))
    real = wan_video.wan_dit_forward
    counts, undo = smoke.count_expert_sweeps(pipe)
    pipe(context=torch.zeros(1, 3, 16), input_image=smoke.seeded_image(0, 32, 32), height=32,
         width=32, num_frames=5, cfg_scale=1.0, num_inference_steps=3, switch_dit_boundary=0.9,
         output_type="latents")
    undo()
    assert counts == [2, 1] and wan_video.wan_dit_forward is real


# -------------------------------------------------- the conditioning phase
@pytest.mark.parametrize("name,model_hash,model_name", [
    ("vace_dit", "7a513e1f257a861512b1afd387a8ecd9", "wan_video_dit"),
    ("vace", "7a513e1f257a861512b1afd387a8ecd9", "wan_video_vace"),
    ("camera_dit", "47dbeab5e560db3180adf51dc0232fb1", "wan_video_dit"),
    ("funref_dit", "2267d489f0ceb9f21836532952852ee5", "wan_video_dit"),
    ("t2v_1_3b", "a61453409b67cd3246cf0c3bebad47ba", "wan_video_dit"),
    ("s2v", "966cffdcc52f9c46c391768b27637614", "wan_video_dit")])
def test_the_conditioning_configs_are_the_registry_entries(smoke, name, model_hash,
                                                           model_name):
    """The conditioning phase's seeded models have the registry's fields;
    the camera DiT's adapter options are the SimpleAdapter's, and the
    Fun-Reference DiT's in_dim is the I2V conditioning's 36, not the
    published 52 (its control-video channels are never filled)."""
    import json

    entries = json.loads((REPO / "fairygen_tpu_torch" / "configs" /
                          "model_registry.json").read_text())
    extra = next(e.get("extra_kwargs", {}) for e in entries
                 if e["model_hash"] == model_hash and e["model_name"] == model_name)
    cfgs = smoke.conditioning_configs()
    cfg = cfgs[name]
    for k, v in extra.items():
        if k in ("add_control_adapter", "in_dim_control_adapter"):
            continue
        want = 36 if (name, k) == ("funref_dit", "in_dim") else v
        assert getattr(cfg, k) == (tuple(want) if isinstance(want, list) else want), k
    if name == "camera_dit":
        assert cfgs["camera"].in_dim == extra["in_dim_control_adapter"]
        assert cfgs["camera"].out_dim == cfg.dim
    if name == "t2v_1_3b":
        assert cfgs["motion"].dim == cfg.dim
    if name == "s2v":
        assert cfgs["wav2vec"].hidden_size == cfg.audio_dim
        assert cfgs["wav2vec"].num_hidden_layers + 1 == cfg.num_audio_layers


def test_the_conditioning_launch_tables(smoke):
    """The per-sweep tables name counters that exist; a VACE sweep adds, a
    VACE block, K1 three times, K3 and K4 once; an S2V sweep runs no K1 and
    12 injector calls of K4; the S2V tables cover 7800 and 10114 tokens."""
    from fairygen_tpu_torch.ops import _kernels

    for table in (smoke.WAN14B_VACE_PER_SWEEP, smoke.S2V_PER_SWEEP, smoke.WAN13B_PER_SWEEP):
        assert set(table) <= set(_kernels.KERNELS)
    n = len(smoke.conditioning_configs()["vace"].vace_layers)
    base = smoke.WAN14B_PER_SWEEP
    assert smoke.WAN14B_VACE_PER_SWEEP == dict(
        base, ln_modulate=base["ln_modulate"] + 3 * n, flash_bounded=base["flash_bounded"] + n,
        flash_small_kv=base["flash_small_kv"] + n)
    s2v = smoke.conditioning_configs()["s2v"]
    assert smoke.S2V_PER_SWEEP == {"rms_rope_heads_major": 2 * s2v.num_layers,
                                   "flash_bounded": s2v.num_layers,
                                   "flash_small_kv": s2v.num_layers
                                   + len(s2v.audio_inject_layers)}
    assert len(smoke.s2v_angles(False)) == 7800 and len(smoke.s2v_angles(True)) == 10114


# ------------------------------------------- the animate_vap_longcat phase
@pytest.mark.parametrize("name,model_hash,model_name", [
    ("animate_dit", "31fa352acb8a1b1d33cd8764273d80a2", "wan_video_dit"),
    ("vap_dit", "5f90e66a0672219f12d9a626c8c21f61", "wan_video_dit")])
def test_the_avl_dits_are_the_registry_entries(smoke, name, model_hash, model_name):
    """The Animate-14B and the VAP's Wan2.1-I2V-14B DiTs have the registry's
    fields (their hashes also map to the adapter and the branch, which the
    pipeline is given); LongCat-Video's entry names no fields: the
    published config."""
    import json

    entries = json.loads((REPO / "fairygen_tpu_torch" / "configs" /
                          "model_registry.json").read_text())
    names = {e["model_name"] for e in entries if e["model_hash"] == model_hash}
    assert names == {model_name, {"animate_dit": "wan_video_animate_adapter",
                                  "vap_dit": "wan_video_vap"}[name]}
    extra = next(e["extra_kwargs"] for e in entries
                 if e["model_hash"] == model_hash and e["model_name"] == model_name)
    cfg = smoke.avl_configs()[name]
    for k, v in extra.items():
        assert getattr(cfg, k) == (tuple(v) if isinstance(v, list) else v), k
    lc = next(e for e in entries if e["model_hash"] == "8b27900f680d7251ce44e2dc8ae1ffef")
    assert lc["model_name"] == "wan_video_dit" and not lc.get("extra_kwargs")
    from fairygen_tpu_torch.models.wan.longcat import LongCatDiTConfig

    assert smoke.avl_configs()["longcat"] == LongCatDiTConfig()


def _spy_launches(monkeypatch):
    """{counter: calls} of the wrappers a forward on CPU tensors reaches,
    named by the kernel each would launch on the card at its padded shapes
    (K3 or K4 bounded by the key tile, K4 max or masked by sk_actual); the
    modules' generic ``attention`` sent to ``flash_attention``, as it is
    for CUDA tensors."""
    from fairygen_tpu_torch.models.wan import dit as tdit
    from fairygen_tpu_torch.models.wan import longcat as tlc
    from fairygen_tpu_torch.models.wan import mot as tmot
    from fairygen_tpu_torch.ops import flash_attention as fa
    from fairygen_tpu_torch.ops import fused_qk as fq

    def as_on_the_card(q, k, v, scale=None, prescaled=False, bounded_logits=False):
        return fa.flash_attention(q, k, v, scale=scale, prescaled=prescaled,
                                  bounded_logits=bounded_logits)

    for mod in (tdit, tmot, tlc):
        monkeypatch.setattr(mod, "attention", as_on_the_card)
    counts = {}

    def counted(name, fn):
        def call(*a, **k):
            key = name(*a, **k) if callable(name) else name
            counts[key] = counts.get(key, 0) + 1
            return fn(*a, **k)
        return call

    bounded = counted(lambda qh, kh, v, **k: "flash_small_kv" if kh.shape[1] == k.get("bk", 1024)
                      else "flash_bounded", fa.flash_attention_heads_major)
    monkeypatch.setattr(fa, "flash_attention_heads_major", bounded)
    monkeypatch.setattr(fq, "flash_attention_heads_major", bounded)
    monkeypatch.setattr(fa, "flash_fwd", counted("flash_fwd", fa.flash_fwd))
    monkeypatch.setattr(fa, "flash_small_kv_max", counted(
        lambda qh, kh, vh, sk_actual: "flash_small_kv_max" if sk_actual == kh.shape[1]
        else "flash_small_kv_masked", fa.flash_small_kv_max))
    monkeypatch.setattr(fq, "rms_rope_heads_major", counted("rms_rope_heads_major",
                                                            fq.rms_rope_heads_major))
    monkeypatch.setattr(tdit, "layer_norm_modulate", counted("ln_modulate",
                                                             tdit.layer_norm_modulate))
    return counts


def test_the_avl_launch_tables_match_a_sweep_at_full_depth(smoke, monkeypatch):
    """One sweep of each model at full depth and tiny width (head dim 128,
    more than 1024 tokens, so each attention takes the kernel of the
    phase's shapes), counted through the wrappers it reaches: Animate's 40
    blocks with the CLIP branch and 8 face blocks, VAP's 40 blocks with 10
    MoT layers (K5 over the joint tokens), LongCat's 48 blocks in T2V and
    cond mode — the phase's tables."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = _avl_sweeps(smoke, monkeypatch)
    finally:
        torch.set_num_threads(threads)
    assert got == {"animate": smoke.ANIMATE_PER_SWEEP, "vap": smoke.VAP_PER_SWEEP,
                   "longcat": smoke.LONGCAT_PER_SWEEP,
                   "longcat cond": smoke.LONGCAT_COND_PER_SWEEP}
    assert smoke.ANIMATE_PER_SWEEP == smoke.WAN14B_CLIP_PER_SWEEP
    from fairygen_tpu_torch.ops import _kernels

    for table in got.values():
        assert set(table) <= set(_kernels.KERNELS)


def _avl_sweeps(smoke, monkeypatch):
    import dataclasses

    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.models.wan import dit as tdit
    from fairygen_tpu_torch.models.wan.longcat import longcat_dit_forward
    from fairygen_tpu_torch.models.wan.mot import wan_dit_forward_vap

    f32 = torch.float32
    cfgs = smoke.avl_configs()
    narrow = dict(dim=128, ffn_dim=64, text_dim=32, freq_dim=32, num_heads=1)
    g = torch.Generator("cpu").manual_seed(0)
    lat, y = torch.randn(1, 16, 3, 40, 40, generator=g), torch.randn(1, 20, 3, 40, 40, generator=g)
    ctx, clip = torch.randn(1, 512, 32, generator=g), torch.randn(1, 257, 1280, generator=g)
    t = torch.tensor([900.0])
    got = {}
    with torch.no_grad():
        dcfg = dataclasses.replace(cfgs["animate_dit"], **narrow)
        dit = convert.init_dit_params(dcfg, "cpu", f32, seed=1)
        acfg = dataclasses.replace(cfgs["animate"], hidden_dim=128, heads_num=1, motion_size=8,
                                   style_dim=16, face_inner=32)
        counts = _spy_launches(monkeypatch)
        tdit.wan_dit_forward(dit, dcfg, lat, t, ctx, y=y, clip_feature=clip,
                             animate_params=convert.init_animate_params(acfg, "cpu", f32, seed=2),
                             animate_cfg=acfg, pose_latents=lat[:, :, 1:],
                             face_pixel_values=torch.rand(1, 3, 5, 8, 8, generator=g))
        got["animate"] = dict(counts)
        mcfg = dataclasses.replace(cfgs["vap"], **narrow)
        counts.clear()
        wan_dit_forward_vap(dit, dcfg, convert.init_mot_params(mcfg, "cpu", f32, seed=3), mcfg,
                            lat, t, ctx, clip_feature=clip, y=y,
                            vap_hidden_state=torch.cat([lat, y], dim=1), context_vap=ctx[:, :40],
                            vap_clip_feature=clip)
        got["vap"] = dict(counts)
        lcfg = dataclasses.replace(cfgs["longcat"], hidden_size=128, num_heads=1,
                                   caption_channels=32, adaln_tembed_dim=32, freq_dim=32)
        lc = convert.init_longcat_params(lcfg, "cpu", f32, seed=4)
        lat = torch.randn(1, 16, 3, 48, 48, generator=g)  # 576 tokens a frame
        for tag, n in (("longcat", 0), ("longcat cond", 2)):
            counts.clear()
            longcat_dit_forward(lc, lcfg, lat, t, ctx, num_cond_latents=n)
            got[tag] = dict(counts)
    return got


def test_streamed_encodes_launch_k11_a_latent_frame(smoke):
    """The phase counts K11 by latent frames: a streamed encode of 1, 17
    and 73 frames (the first-frame, clip and motion-video encodes) and the
    decode of its latents each call the norm + SiLU once a site a latent
    frame (a small v1 VAE on the CPU, through the name its module calls)."""
    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.models.wan import vae as tvae

    cfg = tvae.WanVAEConfig.tiny_v1(dim_mult=(1, 2, 4, 4))
    params = convert.init_vae_params(cfg, "cpu", torch.float32, seed=0)
    enc, dec = smoke.vae_norm_silu_calls(cfg)
    for frames in (1, 17, 73):
        shapes, undo = smoke.record_k11_shapes(tvae)
        try:
            with torch.no_grad():
                z = tvae.vae38_encode(params, cfg, torch.zeros(1, 3, frames, 16, 16),
                                      streaming=True)
                e = sum(shapes.values())
                tvae.vae38_decode(params, cfg, z, streaming=True)
        finally:
            undo()
        lat = (frames - 1) // 4 + 1
        assert z.shape[2] == lat and (e, sum(shapes.values()) - e) == (lat * enc, lat * dec)


PTXAS_LOG = """ptxas info : Compiling entry function '_Z18ln_modulate_kernelILi16EEvPK13bf16'
ptxas info : Used 62 registers, used 0 barriers
ptxas info :     0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info : Compiling entry function '_Z18ln_modulate_kernelILi32EEvPK13bf16'
ptxas info : Used 128 registers, used 0 barriers
ptxas info :     0 bytes stack frame, {spill} bytes spill stores, 0 bytes spill loads
"""


def test_ptxas_report_tells_template_forms_apart(smoke, capsys):
    """K1's two forms (16 and 32 vectors a lane) are matched by their
    template arguments; a spill in either fails the build report."""
    names = ("ln_modulate_kernelILi16E", "ln_modulate_kernelILi32E")
    smoke.ptxas_report(PTXAS_LOG.format(spill=0), names, ("narrow", "wide"))
    out = capsys.readouterr().out
    assert "narrow" in out and "registers 62" in out and "registers 128" in out
    with pytest.raises(RuntimeError, match="ILi32E"):
        smoke.ptxas_report(PTXAS_LOG.format(spill=8), names, ("narrow", "wide"))
    with pytest.raises(RuntimeError, match="no such kernel"):
        smoke.ptxas_report(PTXAS_LOG.format(spill=0), names + ("other_kernel",),
                           ("narrow", "wide", "other"))


def test_stream_vs_full_holds_the_bars(smoke):
    """stream_vs_full passes a rounding-sized difference and raises where a
    frame is lost at a chunk seam (frames on axis 2)."""
    g = torch.Generator().manual_seed(0)
    full = torch.randn((1, 4, 5, 8, 8), generator=g)
    smoke.stream_vs_full("close", full + 1e-3 * torch.randn(full.shape, generator=g), full)
    broken = full.clone()
    broken[:, :, 3] = 0
    with pytest.raises(RuntimeError, match="streamed form disagrees"):
        smoke.stream_vs_full("a lost frame", broken, full)


def test_the_full_launch_tables_name_every_counter(smoke):
    """TRAIN_PER_STEP, compared as a whole with a step's counters, lists
    every counter of ops/_kernels.py, the new kernels' too (0 where the step
    launches none); the SDXL and SD1.5 tables name counters that exist,
    every SD1.5 form checked on the card has its row's shape among those
    checked, and the SD1.5 rows' trace groups cover every row once, each
    with kernel functions of its own."""
    from fairygen_tpu_torch.ops import _kernels

    assert set(smoke.TRAIN_PER_STEP) == set(_kernels.KERNELS)
    for table in (smoke.SDXL_PER_STEP, smoke.SDXL_SWEEP_GRAD,
                  *smoke.SDXL_SWEEP_NO_GRAD.values(), smoke.SD15_PER_STEP,
                  smoke.SD15_MAIN_SHAPE):
        assert set(table) <= set(_kernels.KERNELS)
    assert set(smoke.BF16_D64_KERNELS) <= set(_kernels.KERNELS)
    assert {name for name, *_ in smoke.SD15_SHAPES} == set(smoke.SD15_MAIN_SHAPE)
    assert all(tag in {t for _, t, *_ in smoke.SD15_SHAPES}
               for tag in smoke.SD15_MAIN_SHAPE.values())
    groups = smoke.SD15_ROW_KERNELS
    assert sorted(k for g in groups for k in g) == sorted(smoke.SD15_MAIN_SHAPE)
    assert all(len(set(g.values())) == len(g) for g in groups)


def test_strip_lora_copies_the_base_weights(smoke):
    """The distillation student: the UNet tree without its adapters, every
    tensor a copy."""
    w = torch.ones(2, 2)
    tree = {"a": [{"w": w, "lora": {"A": torch.zeros(2, 1)}}], "b": torch.zeros(3)}
    out = smoke.strip_lora(tree)
    assert set(out["a"][0]) == {"w"} and torch.equal(out["a"][0]["w"], w)
    assert out["a"][0]["w"].data_ptr() != w.data_ptr()
