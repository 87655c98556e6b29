"""PyTorch port: disaggregated serving (``serving/disagg.py``), KV-page
migration (``kv_cache.KVPageExport``), the port's chaos module and the
device preflight.

The oracle: a request served disaggregated (prefill on one engine, its
pages migrated, decode on another) gives the same tokens as the same
request served locally with the same seed, greedy and sampled, with
kv_quant off and on, and its recorded logits agree within 1e-5: a local
request's first token comes from the prefill's last row (B6's plain
version) and a migrated one's from the first decode step (B5's) over
the installed pages, so the two agree to summation order, not bitwise.
Greedy tokens also equal the JAX engine's.  The chaos kill is driven
without timing: the fault is armed before submission and the killed
replica's engine thread is held at its prefill until the router has
killed it, so the in-flight prefill always dies.
"""
import sys
import threading

import numpy as np
import pytest

from paddle_tpu.serving import decode as jdec
from paddle_tpu.serving.server import least_loaded_order as jorder
from paddle_tpu_torch.distributed.fleet.elastic import chaos, preflight
from paddle_tpu_torch.monitor import stat_get
from paddle_tpu_torch.serving import (Autoscaler, CacheConfig,
                                      DecodeConfig, DecodeEngine,
                                      DisaggConfig, DisaggServer,
                                      KVPageExport, PagedKVCache,
                                      TransformerLM, least_loaded_order,
                                      weights_from_numpy)

VOCAB = 128
SELF_TOL = 1e-5
PROMPTS = [[5, 4, 3, 2, 1, 6, 7, 8],   # exactly one page
           list(range(1, 14)),          # two pages, partial tail
           [7]]                         # single-token prompt
SEEDS = [11, 22, 33]


@pytest.fixture(scope="module")
def models():
    import jax

    jm = jdec.TransformerLM(VOCAB, d_model=64, num_layers=2, num_heads=2,
                            max_seq_len=64)
    jw = jm.init_weights(jax.random.PRNGKey(7))
    tm = TransformerLM(VOCAB, d_model=64, num_layers=2, num_heads=2,
                       max_seq_len=64, device="cpu")
    tm.load_weights(weights_from_numpy(
        jax.tree_util.tree_map(np.asarray, jw), "cpu"))
    return jm, jw, tm


def _cfg(**kw):
    return dict(dict(slots=2, max_seq_len=32, page_size=8,
                     max_new_tokens=6), **kw)


class _FakeEngine:
    def __init__(self, free_slots, queue_depth):
        self.free_slots = free_slots
        self.queue_depth = queue_depth


def test_least_loaded_tie_break_is_lowest_index():
    engines = [_FakeEngine(2, 0) for _ in range(4)]
    assert least_loaded_order(engines) == engines == jorder(engines)
    a, b, c, d = (_FakeEngine(1, 2), _FakeEngine(2, 1),
                  _FakeEngine(2, 1), _FakeEngine(2, 0))
    assert least_loaded_order([a, b, c, d]) == [d, b, c, a] == \
        jorder([a, b, c, d])


def _disagg(tm, kv_quant, host_bounce=None, prompts=PROMPTS, **kw):
    srv = DisaggServer(tm, None, config=DecodeConfig(**_cfg(
        kv_quant=kv_quant)), disagg=DisaggConfig(
        prefill_replicas=1, decode_replicas=1, host_bounce=host_bounce))
    with srv:
        reqs = [srv.submit(p, max_new_tokens=5, seed=s, record_logits=True,
                           **kw) for p, s in zip(prompts, SEEDS)]
        outs = [r.result(timeout=120) for r in reqs]
    # engines stopped: the audit reads the books without racing them
    for rep in srv.replicas:
        rep.engine._cache.debug_check()
    return outs, [r.decode_request.logits_trace for r in reqs]


def _local(tm, kv_quant, **kw):
    eng = DecodeEngine(tm, None, DecodeConfig(**_cfg(kv_quant=kv_quant)))
    with eng:
        reqs = [eng.submit(p, max_new_tokens=5, seed=s, record_logits=True,
                           **kw) for p, s in zip(PROMPTS, SEEDS)]
        outs = [r.result(timeout=120) for r in reqs]
    return outs, [r.logits_trace for r in reqs]


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_migrated_equals_local(models, kv_quant, temperature):
    jm, jw, tm = models
    pages0 = stat_get("migrate_pages_total")
    dev0 = stat_get("migrate_device_copies_total")
    douts, dlogits = _disagg(tm, kv_quant, temperature=temperature)
    louts, llogits = _local(tm, kv_quant, temperature=temperature)
    assert douts == louts
    for dl, ll in zip(dlogits, llogits):
        assert len(dl) == len(ll) == 5
        for a, b in zip(dl, ll):
            np.testing.assert_allclose(a, b, rtol=0, atol=SELF_TOL)
    # 1 + 2 + 1 prompt pages migrated, device to device on one device
    assert stat_get("migrate_pages_total") - pages0 == 4
    assert stat_get("migrate_device_copies_total") - dev0 == 3
    if temperature == 0.0:
        jeng = jdec.DecodeEngine(jm, jw, jdec.DecodeConfig(**_cfg(
            kv_quant=kv_quant)))
        with jeng:
            jouts = [jeng.generate(p, max_new_tokens=5) for p in PROMPTS]
        assert douts == jouts


def test_host_bounce_path(models):
    _jm, _jw, tm = models
    b0 = stat_get("migrate_host_bounce_total")
    douts, dlogits = _disagg(tm, True, host_bounce=True)
    louts, llogits = _local(tm, True)
    assert douts == louts
    assert stat_get("migrate_host_bounce_total") - b0 == 3
    for dl, ll in zip(dlogits, llogits):
        for a, b in zip(dl, ll):
            np.testing.assert_allclose(a, b, rtol=0, atol=SELF_TOL)


def test_export_install_round_trip_and_submit_checks(models):
    _jm, _jw, tm = models
    eng = DecodeEngine(tm, None, DecodeConfig(**_cfg(kv_quant=True)))
    with eng:
        r = eng.submit(PROMPTS[1], max_new_tokens=1, extract_kv=True)
        r.result(timeout=120)
    exp = r.kv_export
    assert isinstance(exp, KVPageExport) and exp.n_pages == 2
    assert sorted(exp.arrays) == ["k_pages", "k_scales", "v_pages",
                                  "v_scales"]
    assert exp.nbytes == sum(a.numel() * a.element_size()
                             for a in exp.arrays.values())
    plain = DecodeEngine(tm, None, DecodeConfig(**_cfg()))
    with pytest.raises(ValueError, match="quantized"):
        plain.submit(PROMPTS[1], kv_import=exp)
    with pytest.raises(ValueError, match="covers 13 tokens"):
        eng.submit(PROMPTS[0], kv_import=exp)
    with pytest.raises(ValueError, match="cannot be speculative"):
        eng.submit(PROMPTS[1], kv_import=exp, speculative=True)


def test_debug_check_migrated_page_audit():
    cfg = CacheConfig(2, 2, 8, num_slots=2, max_seq_len=32, page_size=8,
                      quantized=True)
    src, dst = PagedKVCache(cfg, "cpu"), PagedKVCache(cfg, "cpu")
    prompt = list(range(1, 14))  # 13 tokens -> 2 pages
    assert src.claim(0, len(prompt) + 4, prompt=prompt) is not None
    pages = src.slot_pages(0)[:2]
    src.target.k_scales[:, pages] = 0.5   # live scale planes to carry across
    src.target.v_scales[:, pages] = 0.25
    arrays = src.export_pages(pages)
    assert dst.claim(0, len(prompt) + 4, prompt=None) is not None
    dst.install_pages(0, KVPageExport(
        n_tokens=len(prompt), n_pages=2, src_pages=pages, arrays=arrays,
        quantized=True, page_size=8))
    assert len(dst._migrated_in) == 2
    assert float(dst.target.k_scales[:, dst.slot_pages(0)[:2]].min()) == 0.5
    dst.debug_check()  # refcount 1, unregistered, live scales: OK
    # tamper: register a migrated page while it is still slot-owned
    pid = dst.slot_pages(0)[0]
    dst.prefix.register([pid], prompt[:8], on_new=dst._incref)
    with pytest.raises(AssertionError, match="migrated-in page"):
        dst.debug_check()
    dst.prefix.evict(1, can_evict=lambda p: True, on_evict=dst._decref)
    dst.debug_check()
    dst.release(0)
    assert not dst._migrated_in
    dst.debug_check()
    src.release(0)
    src.debug_check()


def test_chaos_prefill_kill_zero_drops(models):
    _jm, _jw, tm = models
    assert sys.modules[
        "paddle_tpu_torch.distributed.fleet.elastic.chaos"] is chaos
    srv = DisaggServer(tm, None, config=DecodeConfig(**_cfg()),
                       disagg=DisaggConfig(prefill_replicas=2,
                                           decode_replicas=1))
    victim = srv.replicas[0]
    killed = threading.Event()
    kill = srv._kill_replica

    def kill_and_release(rep):
        killed.set()
        kill(rep)
    srv._kill_replica = kill_and_release
    service = victim.engine._service_prefills

    def held_prefill():
        # the victim's prefill is in flight until the router kills it
        killed.wait()
        if not victim.dead:
            service()
    victim.engine._service_prefills = held_prefill
    deaths0 = stat_get("disagg_replica_deaths")
    redisp0 = stat_get("disagg_redispatches_total")
    chaos.clear()
    # the deterministic tie-break routes the first request to replica 0,
    # whose handoff hook fires the armed kill
    chaos.inject("kill_prefill_replica", count=1, replica=0)
    try:
        with srv:
            reqs = [srv.submit([3 + i, 5, 7, 9, 2], max_new_tokens=4,
                               seed=100 + i) for i in range(4)]
            outs = [r.result(timeout=120) for r in reqs]
            assert all(len(o) == 4 for o in outs)       # zero drops
            assert stat_get("disagg_replica_deaths") == deaths0 + 1
            assert stat_get("disagg_redispatches_total") > redisp0
            assert [r.dead for r in srv.replicas] == [True, False, False]
        for rep in srv.replicas:
            if not rep.dead:
                rep.engine._cache.debug_check()
    finally:
        chaos.clear()
    eng = DecodeEngine(tm, None, DecodeConfig(**_cfg()))
    with eng:  # the same requests through one local engine
        want = [eng.generate([3 + i, 5, 7, 9, 2], max_new_tokens=4,
                             seed=100 + i) for i in range(4)]
    assert outs == want


class _Signals:
    def __init__(self):
        self.burn, self.queue, self.now, self.preflight_ok = \
            0.0, 0.0, 1000.0, True

    def clock(self):
        return self.now

    def sleep(self, s):
        self.now += s


class _BusyEngine:
    """Stands in for a replica's engine that holds work: the policy
    reads only these three numbers of an engine."""
    free_slots, queue_depth, live_slots = 1, 2, 1


_AUTOSCALE_STATS = ("autoscale_reroles_total",
                    "autoscale_cooldown_skips_total",
                    "autoscale_preflight_failures",
                    "autoscale_drain_timeouts")


def _roles(srv):
    return [r.role for r in srv.replicas]


def _drive_autoscaler(srv, autoscaler_cls, get):
    """One scripted signal sequence through ``autoscaler_cls.tick``:
    per tick, its result, the roles, the draining marks, the clock (the
    drain loop's sleeps advance it) and the counter deltas."""
    sig = _Signals()
    auto = autoscaler_cls(srv, burn_fn=lambda: sig.burn,
                          queue_fn=lambda: sig.queue,
                          preflight=lambda: sig.preflight_ok,
                          clock=sig.clock, sleep=sig.sleep)
    idle = [r.engine for r in srv.replicas]
    log = []

    def tick(busy=(), **signals):
        for k, v in signals.items():
            setattr(sig, k, v)
        for r in srv.replicas:
            r.engine = _BusyEngine() if r.index in busy else idle[r.index]
        before = [get(n) for n in _AUTOSCALE_STATS]
        out = auto.tick()
        log.append((out, _roles(srv), [r.draining for r in srv.replicas],
                    round(sig.now - 1000.0, 6),
                    [get(n) - b for n, b in zip(_AUTOSCALE_STATS, before)]))

    tick()                                   # healthy: no action
    tick(busy=(1,), burn=2.0)                # burn: idle replica 2 drained
    tick(busy=(1,))                          # inside the cooldown: dropped
    sig.now += 31.0
    tick(burn=0.1, queue=5.0)                # queue: prefill 0 comes back
    sig.now += 31.0
    tick(burn=0.5)                           # inside the hysteresis band
    tick(busy=(1,), burn=2.0, preflight_ok=False)   # preflight fails
    tick(busy=(0, 1, 3), preflight_ok=True)  # every candidate busy: timeout
    tick()                                   # drained at once: re-roled
    for r in srv.replicas:
        r.engine = idle[r.index]
    return log


def test_autoscaler_rerole_cooldown_and_preflight(models):
    """The port's policy equals the JAX package's tick for tick on one
    signal sequence: results, roles, which replica drains, the drain
    loop's clock and every counter's delta."""
    from paddle_tpu import monitor as jmonitor
    from paddle_tpu.serving import disagg as jdisagg

    jm, jw, tm = models
    knobs = dict(prefill_replicas=1, decode_replicas=3,
                 autoscale_cooldown_s=30.0, autoscale_burn_high=1.0,
                 autoscale_burn_low=0.25, autoscale_queue_high=4,
                 drain_timeout_s=0.05)
    srv = DisaggServer(tm, None, config=DecodeConfig(**_cfg()),
                       disagg=DisaggConfig(**knobs))
    jsrv = jdisagg.DisaggServer(jm, jw, config=jdec.DecodeConfig(**_cfg()),
                                disagg=jdisagg.DisaggConfig(**knobs))
    assert _roles(srv) == ["prefill", "decode", "decode", "decode"]
    log = _drive_autoscaler(srv, Autoscaler, stat_get)
    jlog = _drive_autoscaler(jsrv, jdisagg.Autoscaler, jmonitor.stat_get)
    assert log == jlog
    assert [e[0] for e in log] == [None, "decode->prefill", None,
                                   "prefill->decode", None, None, None,
                                   "decode->prefill"]
    assert [e[1] for e in log][-1] == ["prefill", "decode", "prefill",
                                       "decode"]
    assert [e[4] for e in log] == [[0, 0, 0, 0], [1, 0, 0, 0],
                                   [0, 1, 0, 0], [1, 0, 0, 0],
                                   [0, 0, 0, 0], [0, 0, 1, 0],
                                   [0, 0, 0, 1], [1, 0, 0, 0]]
    assert not any(any(e[2]) for e in log)


def test_autoscaler_thread_lifecycle(models):
    _jm, _jw, tm = models
    srv = DisaggServer(tm, None, config=DecodeConfig(**_cfg()),
                       disagg=DisaggConfig(prefill_replicas=1,
                                           decode_replicas=1,
                                           autoscale_interval_s=0.01))
    ticked = threading.Event()
    ticks = []

    def burn():
        ticks.append(1)
        if len(ticks) >= 3:
            ticked.set()
        return 0.0
    auto = Autoscaler(srv, burn_fn=burn, queue_fn=lambda: 0.0,
                      preflight=lambda: True)
    auto.start()
    try:
        assert ticked.wait(30), "autoscaler loop never ticked"
        assert stat_get("disagg_prefill_replicas") == 1
        assert stat_get("disagg_decode_replicas") == 1
    finally:
        auto.stop()
    assert auto._thread is None


_PROBES = {
    "ok": ("print('PREFLIGHT_OK', 'gpu', 'card')", "ok"),
    "fails": ("import sys; sys.exit(3)", "compile_error"),
    "times_out": ("import time; time.sleep(30)", "init_timeout"),
}


def _verdicts(mod, chaos_mod, code):
    slept = []
    v = mod.preflight_device(attempts=2, timeout_s=2.0, backoff_s=0.5,
                             probe_code=code, sleep_fn=slept.append)
    chaos_mod.inject("preflight_init_timeout", count=1)
    forced = mod.preflight_device(attempts=1, probe_code=code)
    return (v.verdict, v.ok, v.attempts, v.platform, slept,
            forced.verdict, forced.attempts)


@pytest.mark.parametrize("probe", sorted(_PROBES))
def test_preflight_device_verdicts(probe):
    """The port's preflight gives the JAX package's verdict, attempts,
    platform and backoff sleeps for the same probe code and timeouts,
    and both honour their own chaos module's forced timeout."""
    from paddle_tpu.distributed.fleet.elastic import chaos as jchaos
    from paddle_tpu.distributed.fleet.elastic import preflight as jpre

    code, verdict = _PROBES[probe]
    got = _verdicts(preflight, chaos, code)
    assert got == _verdicts(jpre, jchaos, code)
    assert got[:2] == (verdict, verdict == "ok")
    assert got[2] == (1 if verdict == "ok" else 2)
    assert got[4] == ([] if verdict == "ok" else [0.5])
    assert got[5:] == ("init_timeout", 1)
    if verdict == "ok":
        assert got[3] == "gpu"
