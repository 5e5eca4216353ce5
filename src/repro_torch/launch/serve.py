"""Serving launcher of the port, as `repro.launch.serve`: batched prefill
then a greedy decode loop over `make_batch`'s tokens (no mode flag); the
continuous-batching engine over two tenants (`--engine`), tenant-b a
perturbed variant of tenant-a, both behind one ARAS weight arena of
`--weight-slots` layers, with whole-sequence KV slots or a paged KV cache
(`--kv-layout`), monolithic or chunked prefill (with the radix prefix
cache's chunk skip on the paged layout), fused or split sampling,
wear-aware placement and seeded stuck-at faults, the live telemetry plane
(SLOs, Prometheus text or endpoint, JSONL events, flight recorder, step
watchdog), and a Chrome trace, metrics and wear-map dump on request; or
one forward of the ARAS layer-streaming executor, whose arena holds only
`--arena-slots` layers (`--streaming`).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-7b \
        --batch 4 --prompt-len 512 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --engine \
        --arch gemma-7b --requests 8 --prompt-len 512 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --engine --smoke \
        --device cpu --virtual-clock --trace-out trace.json \
        --metrics-json metrics.json
    PYTHONPATH=src python -m repro_torch.launch.serve --engine --smoke \
        --device cpu --kv-layout paged --prefill-chunk 4 --prefix-cache
    PYTHONPATH=src python -m repro_torch.launch.serve --engine --smoke \
        --device cpu --virtual-clock --kv-layout paged --page-size 4 \
        --wear-aware --fault-rate 0.05 --fault-seed 7 --wear-json wear.json \
        --slo-itl-p95 0.001 --events-out events.jsonl --prom-out prom.txt \
        --flight-recorder-steps 16
    PYTHONPATH=src python -m repro_torch.launch.serve --streaming \
        --arch gemma-7b --arena-slots 3 --batch 4 --prompt-len 512
"""
from __future__ import annotations

import argparse
import atexit
import json
import signal
import sys
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.data.pipeline import DataConfig, make_batch
# serving before launch.steps: the steps module imports serving.sampling,
# whose package imports the engine, which imports the steps
from repro_torch.serving import (EngineModel, FlightRecorder,
                                 InstallCostModel, PromEndpoint,
                                 SchedulerConfig, ServingEngine, SLOConfig,
                                 TelemetryConfig, Tracer, VirtualClock,
                                 drive_simulated, format_summary,
                                 prometheus_text)
from repro_torch.launch.steps import cached_prefill_step, cached_serve_step
from repro_torch.nn.model import init_params
from repro_torch.serving.variants import perturbed_variant


def _json_safe(obj):
    """NaN/inf -> None recursively, so metrics dumps are strict JSON."""
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, float) and not np.isfinite(obj):
        return None
    return obj


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def engine_setup(args, params=None):
    """The `--engine` engine: two tenants, tenant-b a perturbed variant of
    tenant-a (the co-hosted fine-tune regime where cross-tenant §V-C delta
    installs have real structure), in a weight arena smaller than both
    tenants' layer sets, so a tenant switch installs layers.  `params` are
    tenant-a's (default: `init_params(cfg, seed=0)` on `args.device`).
    --virtual-clock puts the engine, and the tracer that --trace-out asks
    for, on one VirtualClock.  Any SLO or exporter flag turns the live
    telemetry plane on; --flight-recorder-steps adds the flight recorder.
    Returns (engine, clock)."""
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.prefix_cache and args.kv_layout != "paged":
        raise SystemExit("--prefix-cache needs --kv-layout paged "
                         "(slot arenas have no pages to retain)")
    base = (params if params is not None
            else init_params(cfg, seed=0, device=args.device))
    variant = perturbed_variant(base)
    kv = dict(kv_slots=args.kv_slots, max_seq=args.prompt_len + args.gen + 8,
              kv_layout=args.kv_layout, page_size=args.page_size,
              prefix_cache=args.prefix_cache,
              prefix_cache_pages=args.prefix_cache_pages)
    tenants = [EngineModel("tenant-a", base, cfg, **kv),
               EngineModel("tenant-b", variant, cfg, **kv)]
    clock = VirtualClock() if args.virtual_clock else time.perf_counter
    slo = None
    if args.slo_ttft_p95 or args.slo_itl_p95 or args.slo_queue_wait_p95:
        slo = SLOConfig(ttft_p95_s=args.slo_ttft_p95,
                        itl_p95_s=args.slo_itl_p95,
                        queue_wait_p95_s=args.slo_queue_wait_p95)
    telemetry = None
    if (slo is not None or args.events_out or args.prom_out
            or args.prom_port):
        telemetry = TelemetryConfig(window=args.telemetry_window, slo=slo,
                                    events_path=args.events_out)
    recorder = (FlightRecorder(args.flight_recorder_steps,
                               out_dir=args.flight_dir)
                if args.flight_recorder_steps else None)
    eng = ServingEngine(
        tenants, weight_arena_slots=args.weight_slots or cfg.n_layers + 1,
        tracer=Tracer(clock=clock) if args.trace_out else None, clock=clock,
        telemetry=telemetry, recorder=recorder,
        stall_timeout_s=args.stall_timeout_s,
        sched=SchedulerConfig(max_prefill_per_step=4,
                              model_turn_steps=args.turn_steps,
                              policy=args.queue_policy,
                              prefill_token_budget=(
                                  args.prefill_token_budget or None)),
        prefill_chunk=args.prefill_chunk,
        bucket_growth=args.bucket_growth,
        staging_growth=args.staging_growth,
        install_ticks_per_step=args.install_ticks_per_step,
        overlap_installs=args.overlap_installs,
        install_cost=InstallCostModel(
            bytes_per_tick=args.install_bytes_per_tick),
        fuse_sampling=not args.no_fuse_sampling,
        wear_aware=args.wear_aware,
        fault_rate=args.fault_rate,
        fault_seed=args.fault_seed,
        device=args.device)
    return eng, clock


def _run_engine(args, params=None) -> ServingEngine:
    """`repro.launch.serve --engine`: submit `--requests` random prompts,
    alternating between the tenants (with --virtual-clock at Poisson
    arrival times in simulated time, through `drive_simulated`), serve them
    and print the summary (and, with telemetry on, the health snapshot).
    The trace, metrics, wear map, Prometheus text and events are written
    once: at the end, or at exit if the run is interrupted (Ctrl-C, or
    SIGTERM turned into a normal exit).  With the flight recorder on,
    SIGUSR1 dumps its ring and an unhandled exception dumps it on the way
    down; --prom-port serves /metrics on localhost while the run lasts."""
    eng, clock = engine_setup(args, params)
    cfg = get_config(args.arch, smoke=args.smoke)
    names = list(eng.models)
    recorder = eng.recorder
    if recorder is not None:
        recorder.install_signal_handler()
        recorder.install_excepthook()
    endpoint = None
    if args.prom_port:
        endpoint = PromEndpoint(
            args.prom_port,
            lambda: prometheus_text(eng.metrics.registry, eng.telemetry))
        print("prometheus endpoint on "
              f"http://127.0.0.1:{endpoint.port}/metrics")
    done = {"flushed": False}

    def flush() -> None:
        if done["flushed"]:
            return
        done["flushed"] = True
        if args.trace_out:
            eng.tracer.export_chrome_trace(args.trace_out)
            print(f"wrote Chrome trace ({len(eng.tracer.events)} events) to "
                  f"{args.trace_out} — load in chrome://tracing or "
                  "https://ui.perfetto.dev")
        if args.metrics_json:
            doc = {"summary": _json_safe(eng.summary()),
                   "metrics": _json_safe(eng.metrics.registry.as_dict())}
            with open(args.metrics_json, "w") as f:
                json.dump(doc, f, indent=2, sort_keys=True)
                f.write("\n")
            print(f"wrote metrics registry + summary to {args.metrics_json}")
        if args.wear_json:
            with open(args.wear_json, "w") as f:
                json.dump(eng.wear.as_json(), f, indent=2, sort_keys=True)
                f.write("\n")
            print(f"wrote wear map ({len(eng.wear.planes)} planes) to "
                  f"{args.wear_json}")
        if args.prom_out:
            with open(args.prom_out, "w") as f:
                f.write(prometheus_text(eng.metrics.registry, eng.telemetry))
            print(f"wrote Prometheus text exposition to {args.prom_out}")
        if eng.telemetry is not None:
            eng.telemetry.close()
        if recorder is not None and recorder.dumps:
            print(f"flight recorder wrote {len(recorder.dumps)} dump(s): "
                  + ", ".join(recorder.dumps))

    if (args.trace_out or args.metrics_json or args.wear_json
            or args.prom_out or args.events_out):
        atexit.register(flush)
        signal.signal(signal.SIGTERM, lambda signum, frame: sys.exit(1))

    rng = np.random.default_rng(0)
    jobs, t = [], 0.0
    for i in range(args.requests):
        plen = int(rng.integers(max(args.prompt_len // 2, 2),
                                args.prompt_len + 1))
        jobs.append((t, names[i % len(names)],
                     rng.integers(1, cfg.vocab, plen).tolist(), args.gen))
        if args.virtual_clock:
            # Poisson-ish arrivals in simulated time (mean gap 4 ms, step
            # dt 2 ms): the whole run is byte-reproducible
            t += float(rng.exponential(0.004))
    if args.virtual_clock:
        summary = drive_simulated(eng, clock, jobs, dt=0.002)
    else:
        for _, model, prompt, gen in jobs:
            eng.submit(model, prompt, max_new_tokens=gen)
        summary = eng.run()
    layout = (f"page size {args.page_size}" if args.kv_layout == "paged"
              else "slot layout")
    print(f"engine: {args.requests} requests across {len(names)} models, "
          f"{args.kv_slots} KV slots each, weight arena "
          f"{eng.residency.arena_slots} slots, {layout}, on {eng.device}")
    print(format_summary(summary))
    if eng.telemetry is not None:
        print("health:", json.dumps(_json_safe(eng.health()),
                                    sort_keys=True))
    flush()
    if endpoint is not None:
        endpoint.close()
    return eng


def run_greedy(args, params=None):
    """The launcher's default mode, as `repro.launch.serve` without a mode
    flag: `make_batch`'s `--batch` x `--prompt-len` tokens prefilled into
    a cache of prompt_len + gen, then `--gen` - 1 greedy steps of the
    batched decode step at one scalar position.  Prints the prefill and
    decode times and the decode rate; returns (tokens (batch, gen) int
    array, prefill seconds, decode seconds)."""
    cfg = get_config(args.arch, smoke=args.smoke)
    if params is None:
        params = init_params(cfg, seed=0, device=args.device)
    device = torch.device(args.device)
    data = DataConfig(seq_len=args.prompt_len, global_batch=args.batch)
    tokens = torch.as_tensor(make_batch(cfg, data, 0)["tokens"],
                             device=device)
    prefill_fn = cached_prefill_step(cfg, args.prompt_len + args.gen)
    serve_fn = cached_serve_step(cfg)

    t0 = time.perf_counter()
    logits, caches = prefill_fn(params, tokens)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    out = [logits.argmax(-1).to(torch.int32)]
    t0 = time.perf_counter()
    for i in range(args.gen - 1):
        logits, caches = serve_fn(params, out[-1], caches,
                                  args.prompt_len + i)
        out.append(logits.argmax(-1).to(torch.int32))
    _sync(device)
    t_decode = time.perf_counter() - t0

    toks = torch.stack(out, 1).cpu().numpy()
    print(f"prefill {args.batch}×{args.prompt_len}: {t_prefill*1e3:.1f} ms; "
          f"decode {args.gen-1} steps: {t_decode*1e3:.1f} ms "
          f"({(args.gen-1)*args.batch/max(t_decode,1e-9):.1f} tok/s)")
    print("sampled token ids:", toks[0, :12], "...")
    return toks, t_prefill, t_decode


def _run_streaming(args) -> None:
    """`repro.launch.serve --streaming`: one streamed forward over step 0 of
    the synthetic data pipeline, `make_batch(cfg, DataConfig(prompt_len,
    batch), 0)`, as the reference feeds it."""
    from repro_torch.streaming.executor import StreamingExecutor
    cfg = get_config(args.arch, smoke=args.smoke)
    params = init_params(cfg, seed=0, device=args.device)
    ex = StreamingExecutor(params, cfg, arena_slots=args.arena_slots,
                           plan_tokens=args.batch * args.prompt_len,
                           device=args.device)
    del params
    data = DataConfig(seq_len=args.prompt_len, global_batch=args.batch)
    batch = {k: torch.as_tensor(v, device=ex.device)
             for k, v in make_batch(cfg, data, 0).items()}
    _, m = ex.forward(batch)
    print(f"streaming forward: {m['wall_s']*1e3:.1f} ms, "
          f"wire {m['wire_bytes']/1e6:.2f} MB vs raw "
          f"{m['raw_bytes']/1e6:.2f} MB "
          f"(skip {m['mean_skip']:.1%}, center={int(m['reuse_center'])}); "
          f"plan overlap speedup {m['plan_overlap_speedup']:.2f}×")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=ARCHS, default="gemma-7b")
    p.add_argument("--smoke", action="store_true")
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--engine", action="store_true",
                      help="continuous-batching engine, 2 tenants")
    mode.add_argument("--streaming", action="store_true",
                      help="one forward of the layer-streaming executor")
    p.add_argument("--arena-slots", type=int, default=3,
                   help="streaming: layers the device arena holds")
    p.add_argument("--batch", type=int, default=4,
                   help="default mode and streaming: sequences in the "
                        "batch")
    p.add_argument("--kv-slots", type=int, default=4,
                   help="engine: KV slots (decode rows) of each tenant")
    p.add_argument("--weight-slots", type=int, default=0,
                   help="engine: weight arena slots (0 = n_layers+1)")
    p.add_argument("--turn-steps", type=int, default=8,
                   help="engine: tenant time-slice length in steps")
    p.add_argument("--queue-policy", choices=("fcfs", "sjf"), default="fcfs",
                   help="engine: admission order of queued requests")
    p.add_argument("--kv-layout", choices=("slot", "paged"), default="slot",
                   help="engine: whole-sequence KV slots, or paged KV with "
                        "prefix sharing (removes the per-request max_seq "
                        "ceiling)")
    p.add_argument("--install-ticks-per-step", type=int, default=0,
                   help="engine: weight-install tick budget per step "
                        "(0 = instant installs at the turn boundary)")
    p.add_argument("--install-bytes-per-tick", type=int, default=1 << 16,
                   help="engine: wire bytes one install tick moves")
    p.add_argument("--overlap-installs", action="store_true",
                   help="engine: pipeline the next tenant's weight installs "
                        "under the current tenant's final decode steps "
                        "(needs --install-ticks-per-step > 0)")
    p.add_argument("--prefill-chunk", type=int, default=0,
                   help="engine: split prompt prefills into chunks of this "
                        "many tokens, spread across steps (0 = monolithic "
                        "per-prompt-length prefill)")
    p.add_argument("--prefill-token-budget", type=int, default=0,
                   help="engine: cap on prompt tokens one step may spend on "
                        "chunked prefill (0 = unbudgeted; needs "
                        "--prefill-chunk > 0 to matter)")
    p.add_argument("--bucket-growth", type=float, default=2.0,
                   help="engine: geometric growth of the prompt-length "
                        "bucket ladder tail chunks are padded to; bounds "
                        "the distinct chunk shapes at the ladder size "
                        "(<= 1 disables bucketing)")
    p.add_argument("--staging-growth", type=float, default=2.0,
                   help="engine: geometric growth of the staging-length "
                        "ladder — each chunked prefill stages into the "
                        "smallest rung covering its prompt instead of one "
                        "max-capacity buffer (<= 1 restores the single "
                        "max-capacity staging length)")
    p.add_argument("--prefix-cache", action="store_true",
                   help="engine: radix-tree prefix cache over KV pages "
                        "(--kv-layout paged): finished requests donate "
                        "their pages, warm requests skip prefill chunks "
                        "covered by cached pages, LRU eviction frees pages "
                        "on demand")
    p.add_argument("--prefix-cache-pages", type=int, default=0,
                   help="engine: cap on retained prefix-cache pages per "
                        "tenant (0 = bounded only by on-demand eviction)")
    p.add_argument("--page-size", type=int, default=8,
                   help="engine: tokens per KV page (--kv-layout paged)")
    p.add_argument("--no-fuse-sampling", action="store_true",
                   help="engine: split sampling back out of the paged "
                        "decode step (fused on-device sampling is the "
                        "default — logits never leave the device)")
    p.add_argument("--trace-out", type=str, default="",
                   help="engine: write a Chrome-trace-format JSON of the "
                        "run (per-step component spans + request lifecycle "
                        "spans) to this path; load in chrome://tracing or "
                        "ui.perfetto.dev")
    p.add_argument("--metrics-json", type=str, default="",
                   help="engine: dump the final summary and the typed "
                        "metrics registry (counters/gauges/histograms) as "
                        "JSON to this path")
    p.add_argument("--wear-aware", type=float, nargs="?", const=1.0,
                   default=0.0, metavar="WEIGHT",
                   help="engine: blend install victim picking with per-slot "
                        "write pressure and hand out the coldest free KV "
                        "page first (Hamun-style wear leveling); optional "
                        "value is the blend weight (bare flag = 1.0, "
                        "0 = off, today's placement bit-for-bit)")
    p.add_argument("--fault-rate", type=float, default=0.0,
                   help="engine: seeded stuck-at fault probability per "
                        "physical write (weight slots + KV pages); faulted "
                        "units are retired and remapped with token "
                        "equivalence preserved (0 = no injection)")
    p.add_argument("--fault-seed", type=int, default=0,
                   help="engine: seed for the deterministic fault stream "
                        "(same seed + same schedule = same faults)")
    p.add_argument("--wear-json", type=str, default="",
                   help="engine: dump the per-plane wear map (write / "
                        "cell-flip / pulse counts per weight slot and KV "
                        "page, Gini, hottest-N, histogram) as JSON to this "
                        "path; artifacts also flush on Ctrl-C/SIGTERM")
    p.add_argument("--slo-ttft-p95", type=float, default=0.0,
                   metavar="SECONDS",
                   help="engine: TTFT p95 SLO target in seconds — "
                        "evaluated as short+long burn-rate windows, "
                        "breach/recover transitions emit trace instants "
                        "and flight-recorder dumps (0 = untracked)")
    p.add_argument("--slo-itl-p95", type=float, default=0.0,
                   metavar="SECONDS",
                   help="engine: worst inter-token-gap p95 SLO target in "
                        "seconds (0 = untracked)")
    p.add_argument("--slo-queue-wait-p95", type=float, default=0.0,
                   metavar="SECONDS",
                   help="engine: queue-wait p95 SLO target in seconds "
                        "(0 = untracked)")
    p.add_argument("--telemetry-window", type=int, default=128,
                   help="engine: sliding-window size for live windowed "
                        "percentiles (exact over the last N samples; "
                        "lifetime P² estimators ride along at O(1))")
    p.add_argument("--prom-out", type=str, default="",
                   help="engine: write Prometheus text exposition "
                        "(registry + live windows + SLO status) to this "
                        "path at exit — the textfile-collector mode")
    p.add_argument("--prom-port", type=int, default=0,
                   help="engine: serve /metrics on this localhost port "
                        "via a stdlib http.server daemon thread "
                        "(0 = no endpoint)")
    p.add_argument("--events-out", type=str, default="",
                   help="engine: append-mode JSONL event stream (per-step "
                        "window snapshots, request finishes, SLO "
                        "transitions) to this path")
    p.add_argument("--flight-recorder-steps", type=int, default=0,
                   help="engine: keep a flight-recorder ring of the last "
                        "N steps (StepRecords + trace events + health), "
                        "dumped to JSON on unit retirement, SLO breach, "
                        "suspected stall, SIGUSR1, or crash (0 = off)")
    p.add_argument("--flight-dir", type=str, default=".",
                   help="engine: directory flight-recorder dumps are "
                        "written into")
    p.add_argument("--stall-timeout-s", type=float, default=0.0,
                   help="engine: arm the step watchdog with this deadline "
                        "— a step that overruns it emits stall_suspected "
                        "+ a flight dump; observation only (0 = off)")
    p.add_argument("--virtual-clock", action="store_true",
                   help="engine: run on a VirtualClock with deterministic "
                        "simulated arrivals — every artifact is "
                        "byte-reproducible")
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--gen", type=int, default=16)
    p.add_argument("--requests", type=int, default=10,
                   help="engine: number of requests to submit")
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu runs the plain kernel versions)")
    return p


def main() -> None:
    args = _parser().parse_args()
    if args.engine:
        _run_engine(args)
    elif args.streaming:
        _run_streaming(args)
    else:
        run_greedy(args)


if __name__ == "__main__":
    main()
