"""Command-line surface of the port (``amss_tpu/cli.py``): the same ten
commands, flags and JSON lines, on the card (``--device cuda``, the default)
or on the CPU (``--device cpu``).

  python -m amss_tpu_torch make-synthetic --out /tmp/corpus
  python -m amss_tpu_torch train --recipe c1 --corpus /tmp/corpus
  python -m amss_tpu_torch train --recipe c2 --corpus /tmp/corpus \\
      --pretrained-front runs/c2_pretrain_<id>
  python -m amss_tpu_torch evaluate --recipe c1 --corpus /tmp/corpus --run-dir ...
  python -m amss_tpu_torch separate --recipe c1 --run-dir ... --wav a.wav b.wav
  python -m amss_tpu_torch export --recipe c1 --corpus ... --run-dir ... --out DIR
  python -m amss_tpu_torch serve --export-dir DIR --port 8080

``--device`` takes the place of the JAX CLI's ``--platform`` and works in any
position.  ``train --data-axis N`` trains on N ranks (``train/engine.py``):
it starts them itself, one per card over NCCL (more than the visible cards
raises), or N CPU ranks over gloo with ``--device cpu``; started by
``torchrun`` (``RANK`` and ``WORLD_SIZE`` set) it runs as that one rank.
``separate --mesh-devices N`` spreads the chunks of over-bucket utterances
over N cards (N CPU entries with ``--device cpu``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def _add_train_overrides(p: argparse.ArgumentParser):
    p.add_argument("--steps", type=int)
    p.add_argument("--batch-size", type=int)
    p.add_argument("--chunk-samples", type=int)
    p.add_argument("--lr", type=float)
    p.add_argument("--lr-schedule", choices=["const", "cosine"])
    p.add_argument("--warmup-steps", type=int)
    p.add_argument("--seed", type=int)
    p.add_argument("--valid-every", type=int)
    p.add_argument("--data-axis", type=int,
                   help="data-parallel ranks: train starts one per card (nccl), or CPU "
                        "ranks over gloo with --device cpu")
    p.add_argument("--device-data", action="store_const", const=True, default=None,
                   help="upload the corpus to the card once and send each step a plan "
                        "(speaker ids, starts, gains) that the card gathers")
    p.add_argument("--accum-steps", type=int,
                   help="gradient accumulation microbatches per step")
    p.add_argument("--steps-per-call", type=int,
                   help="accepted for the JAX CLI's runs; the same per-step loop, "
                        "excluded from the run id")
    p.add_argument("--ema-decay", type=float,
                   help="parameter EMA decay (0 = off); EMA weights are validated, "
                        "ranked for ckpt_best, and served")
    p.add_argument("--valid-quality", action="store_const", const=True, default=None,
                   help="also log valid/si_sdri (the full inference path on one valid "
                        "batch) at every validation")
    p.add_argument("--early-stop-patience", type=int,
                   help="stop after N validations without a new best valid loss "
                        "(0 = off; ckpt_best keeps the best)")
    p.add_argument("--hidden", type=int)
    p.add_argument("--layers", type=int)
    p.add_argument("--embed-dim", type=int)
    p.add_argument("--compute-dtype", choices=["float32", "bfloat16"])
    p.add_argument("--trunk", choices=["blstm", "dprnn", "tcn", "dpt"])
    p.add_argument("--heads", type=int, help="dpt attention heads")
    p.add_argument("--blocks", type=int,
                   help="dprnn/dpt dual-path block count / tcn blocks per repeat")
    p.add_argument("--repeats", type=int, help="tcn dilation-ladder repeats")
    p.add_argument("--kernel", type=int, help="tcn depthwise kernel width")
    p.add_argument("--expansion", type=int,
                   help="tcn conv channels / dpt ffn dim = expansion * hidden")
    p.add_argument("--chunk-frames", type=int, help="dprnn/dpt intra-chunk length K")
    p.add_argument("--dropout", type=float)
    p.add_argument("--feature-norm", choices=["global", "channel", "cumulative"])
    p.add_argument("--causal", action=argparse.BooleanOptionalAction, default=None,
                   help="causal TCN trunk (low-latency streaming, recipe c7); "
                        "--no-causal overrides a recipe's causal default")
    p.add_argument("--loss-variant", choices=["msa", "psa", "sisdr"],
                   help="mask-inference target (psa = phase-sensitive)")
    p.add_argument("--weight-kind", choices=["vad", "magnitude", "magvad"])
    p.add_argument("--vad-threshold-db", type=float)
    p.add_argument("--train-noise-snr", type=float, nargs=2, metavar=("LO", "HI"),
                   help="corrupt the observed mixture with white noise at a per-utterance "
                        "SNR drawn from [LO, HI] dB (targets stay clean)")
    p.add_argument("--train-reverb-rt60", type=float, nargs=2, metavar=("LO", "HI"),
                   help="convolve each source with its own synthetic RIR, RT60 drawn from "
                        "[LO, HI] seconds (targets stay dry)")
    p.add_argument("--train-reverb-drr", type=float, nargs=2, metavar=("LO", "HI"),
                   help="direct-to-reverb ratio draw in dB for the synthetic RIRs "
                        "(default 0 10; needs --train-reverb-rt60)")
    p.add_argument("--min-speakers", type=int,
                   help="count-diverse training (clustering recipes): each sample draws "
                        "an active speaker count from {MIN..nb_speakers}, the rest zeroed "
                        "(enables separate --num-speakers auto)")


def _overrides(pairs: dict) -> dict:
    return {k: v for k, v in pairs.items() if v is not None}


def _build_recipe(args, store):
    from amss_tpu_torch.configs.recipes import ALL_RECIPES

    factory = ALL_RECIPES[args.recipe]
    kwargs = {}
    if args.recipe == "c3":
        kwargs["n_train_speakers"] = len(store.speakers)
    if args.recipe == "c2" and getattr(args, "pretrained_front", None):
        kwargs["pretrained_front"] = args.pretrained_front
    if args.recipe == "enh":
        kwargs["base_run"] = args.base_run
    recipe = factory(**kwargs)

    def arg(name):  # callers (tests, scripts) may pass partial Namespaces
        return getattr(args, name, None)

    tover = _overrides({
        "steps": arg("steps"), "batch_size": arg("batch_size"),
        "chunk_samples": arg("chunk_samples"), "lr": arg("lr"),
        "lr_schedule": arg("lr_schedule"), "warmup_steps": arg("warmup_steps"),
        "seed": arg("seed"), "valid_every": arg("valid_every"), "data_axis": arg("data_axis"),
        "device_data": arg("device_data"), "accum_steps": arg("accum_steps"),
        "steps_per_call": arg("steps_per_call"), "ema_decay": arg("ema_decay"),
        "valid_quality": arg("valid_quality"),
        "early_stop_patience": arg("early_stop_patience"),
    })
    sover = _overrides({k: arg(k) for k in (
        "hidden", "layers", "embed_dim", "compute_dtype", "trunk", "blocks", "repeats",
        "kernel", "expansion", "chunk_frames", "heads", "dropout", "feature_norm", "causal")})
    mover = _overrides({
        "loss_variant": arg("loss_variant"),
        "weight_kind": arg("weight_kind"),
        "vad_threshold_db": arg("vad_threshold_db"),
        "train_noise_snr_db": (tuple(args.train_noise_snr)
                               if arg("train_noise_snr") is not None else None),
        "train_reverb_rt60": (tuple(int(round(s * recipe.sample_rate))
                                    for s in args.train_reverb_rt60)
                              if arg("train_reverb_rt60") is not None else None),
        "train_reverb_drr_db": (tuple(args.train_reverb_drr)
                                if arg("train_reverb_drr") is not None else None),
        "train_min_speakers": arg("min_speakers"),
    })
    if "train_reverb_drr_db" in mover and "train_reverb_rt60" not in mover:
        raise SystemExit("--train-reverb-drr needs --train-reverb-rt60")
    if tover:
        recipe = dataclasses.replace(recipe, train=dataclasses.replace(recipe.train, **tover))
    if sover or mover:
        recipe = dataclasses.replace(recipe, model=dataclasses.replace(
            recipe.model, sep=dataclasses.replace(recipe.model.sep, **sover), **mover))
    if recipe.model.loss_variant == "sisdr" and recipe.model.kind != "enhance":
        raise SystemExit(
            "--loss-variant sisdr is the enhancement-stage waveform objective (recipe enh); "
            f"model kind {recipe.model.kind!r} trains msa/psa only")
    ms = recipe.model.train_min_speakers
    if ms is not None:
        if recipe.model.kind not in ("dpcl", "chimera"):
            raise SystemExit(
                "--min-speakers trains a variable-count clustering embedding; model kind "
                f"{recipe.model.kind!r} is not a clustering objective (use recipes c1/c4)")
        if not 1 <= ms <= recipe.model.nb_speakers:
            raise SystemExit(f"--min-speakers {ms} must be in [1, nb_speakers="
                             f"{recipe.model.nb_speakers}]")
    return recipe


def cmd_make_synthetic(args):
    from amss_tpu_torch.data.synthetic import make_synthetic_corpus

    make_synthetic_corpus(args.out, n_speakers=args.speakers, seconds_per_speaker=args.seconds)
    print(f"synthetic corpus: {args.speakers} speakers at {args.out}")


def cmd_ingest(args):
    from amss_tpu_torch.data.store import ingest_wav_tree

    store = ingest_wav_tree(args.wav_root, args.out, sample_rate=args.sample_rate)
    print(f"ingested {len(store.speakers)} speakers into {args.out} at {store.sample_rate} Hz")


def _trainer(args, store, recipe):
    from amss_tpu_torch.train.engine import Trainer

    return Trainer(recipe, store, workdir=args.workdir,
                   run_dir=getattr(args, "run_dir", None), device=args.device)


def _train_rank(rank: int, world: int, args, devices) -> None:
    """Train as rank ``rank`` of ``world`` on ``devices[rank]`` (one
    process's whole run when ``world`` is 1)."""
    from amss_tpu_torch.data.store import SpeakerStore
    from amss_tpu_torch.train.engine import Trainer

    store = SpeakerStore(args.corpus)
    recipe = _build_recipe(args, store)
    trainer = Trainer(recipe, store, workdir=args.workdir, device=devices[rank])
    if rank == 0:
        print(f"run dir: {trainer.dir}", flush=True)
    state = trainer.restore() if args.resume else None
    trainer.fit(state)


def cmd_train(args):
    from amss_tpu_torch.parallel.mesh import init_data_parallel, make_mesh, run_ranks

    n = args.data_axis or 1
    backend = "nccl" if args.device == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # one rank of a torchrun launch
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        device = (f"cuda:{os.environ.get('LOCAL_RANK', rank)}" if args.device == "cuda"
                  else "cpu")
        init_data_parallel(backend, rank, world, "env://", device)
        try:
            _train_rank(rank, world, args, {rank: device})
        finally:
            import torch.distributed as dist

            dist.destroy_process_group()
    elif n > 1:
        devices = make_mesh(n) if args.device == "cuda" else ["cpu"] * n
        run_ranks(_train_rank, n, backend, args=(args, devices), devices=devices)
    else:
        _train_rank(0, 1, args, [args.device])


def _load_for_inference(args, store):
    """(model, recipe): from --run-dir's config.json when given (the record
    of what was trained), else from the flags' run dir's best checkpoint;
    EMA runs serve the averaged weights."""
    import torch

    if getattr(args, "run_dir", None):
        from amss_tpu_torch.utils.config import recipe_from_dict
        from amss_tpu_torch.weights import load_model_from_run

        model = load_model_from_run(args.run_dir, device=args.device)
        with open(os.path.join(args.run_dir, "config.json")) as f:
            return model, recipe_from_dict(json.load(f))
    recipe = _build_recipe(args, store)
    tr = _trainer(args, store, recipe)
    state = tr.restore(best=True)
    params = state.get("ema_params") or state["params"]
    with torch.no_grad():
        for n, p in tr.model.named_parameters():
            if n in params:
                p.copy_(params[n])
    return tr.model.eval(), recipe


def _test_mixtures(store, recipe, n: int):
    """The first ``n`` test-split mixtures of the recipe's mixer: (sources
    [S, T] each, their sums)."""
    from amss_tpu_torch.data.mixer import Mixer

    mixer = Mixer(store, nb_speakers=recipe.model.nb_speakers,
                  chunk_samples=recipe.train.chunk_samples, seed=recipe.train.seed)
    refs = [mixer.batch("test", i, 1).sources[0] for i in range(n)]
    return refs, [r.sum(0) for r in refs]


def cmd_evaluate(args):
    import numpy as np
    import torch

    from amss_tpu_torch.data.store import SpeakerStore
    from amss_tpu_torch.infer.evaluate import evaluate_separation
    from amss_tpu_torch.infer.streaming import StreamingSeparator

    store = SpeakerStore(args.corpus)
    model, recipe = _load_for_inference(args, store)
    refs, mixes = _test_mixtures(store, recipe, args.n_mixtures)
    noise_rng = np.random.default_rng(1234)  # deterministic noisy evaluation
    for i in range(len(mixes)):
        if getattr(args, "reverb_rt60", None) is not None:
            # per-source synthetic rooms at a fixed RT60, one key per mixture;
            # the metrics stay against the dry references
            from amss_tpu_torch.models.dprnn import DropoutKey
            from amss_tpu_torch.models.front import reverberate_sources

            rt = int(round(args.reverb_rt60 * recipe.sample_rate))
            wet = reverberate_sources(torch.from_numpy(refs[i][None]),
                                      DropoutKey(1234).fold_in(i), (rt, rt))
            mixes[i] = wet[0].numpy().sum(0)
        if getattr(args, "noise_snr", None) is not None:
            m = mixes[i]
            noise = noise_rng.standard_normal(m.shape).astype(np.float32)
            scale = (np.sqrt(np.mean(m**2)) * 10.0 ** (-args.noise_snr / 20.0)
                     / max(np.sqrt(np.mean(noise**2)), 1e-9))
            mixes[i] = m + noise * scale
    sep = StreamingSeparator(model, sample_rate=recipe.sample_rate, device=args.device)
    est = sep.separate_all(mixes)
    out = evaluate_separation(np.stack(est), np.stack(refs), np.stack(mixes), per_utt=True,
                              with_stoi=getattr(args, "stoi", False),
                              sample_rate=recipe.sample_rate)
    out.pop("si_sdri_per_utt", None)
    out.pop("sdri_per_utt", None)
    out["rtf"] = sep.meter.rtf
    out["utterances_per_sec"] = sep.meter.utterances_per_sec
    print(json.dumps(out))


def _write_separated(wav_paths, ests, out_dir, sample_rate, rtf):
    from amss_tpu_torch.infer.evaluate import write_wav

    os.makedirs(out_dir, exist_ok=True)
    for path, est in zip(wav_paths, ests):
        base = os.path.splitext(os.path.basename(path))[0]
        for s in range(est.shape[0]):
            write_wav(os.path.join(out_dir, f"{base}_spk{s}.wav"), est[s], sample_rate)
    print(f"wrote {sum(e.shape[0] for e in ests)} wavs to {out_dir} (rtf={rtf:.4f})")


def cmd_separate(args):
    from amss_tpu_torch.data.store import SpeakerStore, _read_wav
    from amss_tpu_torch.infer.streaming import StreamingSeparator

    store = SpeakerStore(args.corpus)
    model, recipe = _load_for_inference(args, store)
    waves = [_read_wav(p)[0] for p in args.wav]
    if getattr(args, "num_speakers", None) == "auto":
        from amss_tpu_torch.infer.count import separate_auto_k

        if not (hasattr(model, "embed") or hasattr(model, "heads")):
            raise SystemExit("--num-speakers auto needs an embedding model (dpcl/chimera); "
                             f"recipe {args.recipe!r} is kind {recipe.model.kind!r}")
        ks, ests, rtf = separate_auto_k(
            model, waves, k_max=args.max_speakers,
            weight_kind=getattr(args, "count_weights", "vad"),
            sample_rate=recipe.sample_rate, device=args.device)
        print(json.dumps({"estimated_speakers": dict(zip(args.wav, ks))}))
        _write_separated(args.wav, ests, args.out, recipe.sample_rate, rtf)
        return
    kw = {}
    if getattr(args, "num_speakers", None) is not None:
        k = int(args.num_speakers)
        if k != recipe.model.nb_speakers:
            if not hasattr(model, "embed"):
                raise SystemExit(
                    f"recipe {args.recipe!r} ({recipe.model.kind}) emits a fixed "
                    f"{recipe.model.nb_speakers} sources; only clustering models (dpcl) "
                    "separate at a different k")
            kw["n_speakers"] = k
    mesh = None
    if getattr(args, "mesh_devices", None):
        from amss_tpu_torch.parallel.mesh import make_mesh

        mesh = (make_mesh(args.mesh_devices) if args.device == "cuda"
                else ["cpu"] * args.mesh_devices)
    sep = StreamingSeparator(model, sample_rate=recipe.sample_rate, separate_kwargs=kw,
                             device=args.device, mesh=mesh)
    ests = sep.separate_all(waves)
    _write_separated(args.wav, ests, args.out, recipe.sample_rate, sep.meter.rtf)


def cmd_export(args):
    """Export the trained serving function (``torch.export`` programs and the
    parameters) into a directory that serves without the model code
    (``infer/export.py``)."""
    from amss_tpu_torch.data.store import SpeakerStore
    from amss_tpu_torch.infer.export import export_realtime, export_serving
    from amss_tpu_torch.utils.config import recipe_to_dict

    store = SpeakerStore(args.corpus)
    model, recipe = _load_for_inference(args, store)
    common = dict(platforms=tuple(args.platforms), sample_rate=recipe.sample_rate,
                  recipe_dict=recipe_to_dict(recipe), quantize=args.quantize)
    if args.realtime:
        export_realtime(model, args.out, chunk_samples=args.rt_chunk,
                        n_streams=args.rt_streams, **common)
    else:
        export_serving(model, args.out, lengths=tuple(args.lengths), batch=args.serve_batch,
                       **common)
    sizes = {f: os.path.getsize(os.path.join(args.out, f)) for f in sorted(os.listdir(args.out))}
    print(json.dumps({"export_dir": args.out, "files": sizes}))


def cmd_separate_exported(args):
    """Separate WAVs through an exported artifact: no recipe, no corpus, no
    model classes."""
    from amss_tpu_torch.data.store import _read_wav
    from amss_tpu_torch.infer.export import RealtimeArtifact, ServingArtifact

    with open(os.path.join(args.export_dir, "export_meta.json")) as f:
        kind = json.load(f).get("kind", "offline")
    waves = [_read_wav(p)[0] for p in args.wav]
    if kind == "realtime":
        art = RealtimeArtifact(args.export_dir, device=args.device)
        if art.b == 1:
            ests = [art.separate_stream(w) for w in waves]
        else:  # a multi-stream artifact serves the wavs in groups of its slots
            ests = []
            for i in range(0, len(waves), art.b):
                group = waves[i : i + art.b]
                ests.extend(art.separate_streams(group)[: len(group)])
        rtf = float("nan")  # the streamed path has no bucket meter
    else:
        art = ServingArtifact(args.export_dir, device=args.device)
        ests = art.separate_all(waves)
        rtf = art.meter.rtf
    _write_separated(args.wav, ests, args.out, art.sample_rate, rtf)


def _parse_grid(specs: list[str]) -> list[dict]:
    """["lr=1e-3,3e-4", "expansion=2,4"] -> the cartesian product of override
    dicts (4 combos).  Values are typed int, then float, then true/false,
    else string."""
    import itertools

    def typed(v: str):
        for cast in (int, float):
            try:
                return cast(v)
            except ValueError:
                pass
        if v.lower() in ("true", "false"):
            return v.lower() == "true"
        return v

    axes = []
    for spec in specs:
        if "=" not in spec:
            raise SystemExit(f"--grid entries are key=v1,v2,... (got {spec!r})")
        key, vals = spec.split("=", 1)
        key = key.replace("-", "_")
        axes.append([(key, typed(v)) for v in vals.split(",") if v != ""])
    return [dict(combo) for combo in itertools.product(*axes)]


def cmd_sweep(args):
    """Train and evaluate every grid combo in turn: one JSON line per combo
    and a final ranking.  Grid keys are the train-override flag names (lr,
    expansion, trunk, ema-decay, ...)."""
    import copy

    import numpy as np

    from amss_tpu_torch.data.store import SpeakerStore
    from amss_tpu_torch.infer.evaluate import evaluate_separation
    from amss_tpu_torch.infer.streaming import StreamingSeparator

    store = SpeakerStore(args.corpus)
    combos = _parse_grid(args.grid)
    rows = []
    for i, combo in enumerate(combos):
        a = copy.copy(args)
        for k, v in combo.items():
            if not hasattr(a, k):
                raise SystemExit(f"unknown grid key {k!r} (not a train flag)")
            setattr(a, k, v)
        a.run_dir = None
        recipe = _build_recipe(a, store)
        tr = _trainer(a, store, recipe)
        print(json.dumps({"combo": combo, "run_dir": tr.dir,
                          "status": f"training {i + 1}/{len(combos)}"}), flush=True)
        state = tr.fit()
        refs, mixes = _test_mixtures(store, recipe, args.n_mixtures)
        with tr._serving_weights():  # the EMA weights where EMA is on
            est = StreamingSeparator(tr.model, sample_rate=recipe.sample_rate,
                                     device=args.device).separate_all(mixes)
        q = evaluate_separation(np.stack(est), np.stack(refs), np.stack(mixes), bss=False)
        row = {"combo": combo, "run_dir": tr.dir, "step": state["step"],
               "si_sdri": round(q["si_sdri"], 3)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    rows.sort(key=lambda r: -r["si_sdri"])
    print(json.dumps({"ranking": rows}), flush=True)


def cmd_serve(args):
    """The HTTP serving daemon over an exported artifact (``infer/server.py``)."""
    from amss_tpu_torch.infer.server import SeparationServer

    srv = SeparationServer(args.export_dir, host=args.host, port=args.port, device=args.device)
    print(json.dumps({"serving": args.export_dir, "kind": srv.kind, "host": args.host,
                      "port": srv.port}), flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()


def cmd_profile(args):
    """Trace N train steps with ``torch.profiler`` (a Chrome trace, with the
    card's kernels where there is one) and print wall-clock step stats."""
    from amss_tpu_torch.data.store import SpeakerStore
    from amss_tpu_torch.utils.profiling import StepTimer, trace

    store = SpeakerStore(args.corpus)
    recipe = _build_recipe(args, store)
    tr = _trainer(args, store, recipe)
    tr.load_state(tr.init_state())
    b = recipe.train.batch_size

    def step(i):
        m = tr._train_step(tr._device_batch(tr.mixer.batch("train", i, b)))
        return {k: float(v) for k, v in m.items()}  # the fetch waits for the step

    step(0)  # warm-up, outside the trace
    timer = StepTimer()
    with trace(args.trace_dir, device=tr.device):
        timer.start()
        for i in range(args.profile_steps):
            step(i + 1)
            timer.tick()
    stats = {k: round(v, 5) for k, v in timer.stats().items()}
    print(json.dumps({"trace_dir": args.trace_dir, **stats}))


def _pop_device(argv: list[str]) -> str:
    """Take ``--device X`` (or ``--device=X``) out of argv, in any position."""
    device = "cuda"
    for i, a in enumerate(argv):
        if a == "--device" and i + 1 < len(argv):
            device = argv[i + 1]
            del argv[i : i + 2]
            break
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
            del argv[i]
            break
    if device not in ("cpu", "cuda"):
        raise SystemExit(f"--device {device!r}: cpu or cuda")
    return device


def main(argv=None):
    from amss_tpu_torch.configs.recipes import ALL_RECIPES

    argv = list(sys.argv[1:] if argv is None else argv)
    device = _pop_device(argv)
    ap = argparse.ArgumentParser(prog="amss_tpu_torch")
    # taken out of argv above, so that it works in any position; registered
    # here for --help
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where every command runs (default cuda; cpu runs the kernels' "
                         "plain versions)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("make-synthetic")
    p.add_argument("--out", required=True)
    p.add_argument("--speakers", type=int, default=12)
    p.add_argument("--seconds", type=float, default=30.0)
    p.set_defaults(fn=cmd_make_synthetic)

    p = sub.add_parser("ingest")
    p.add_argument("--wav-root", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--sample-rate", type=int, default=None,
                   help="store rate; files at other rates are resampled (default: the "
                        "first file's rate)")
    p.set_defaults(fn=cmd_ingest)

    for name, fn in [("train", cmd_train), ("evaluate", cmd_evaluate),
                     ("separate", cmd_separate), ("profile", cmd_profile),
                     ("export", cmd_export), ("sweep", cmd_sweep)]:
        p = sub.add_parser(name)
        p.add_argument("--recipe", required=True, choices=sorted(ALL_RECIPES))
        p.add_argument("--corpus", required=True)
        p.add_argument("--workdir", default="runs")
        p.add_argument("--pretrained-front")
        p.add_argument("--base-run", help="frozen base separator run dir (enh)")
        p.add_argument("--run-dir", help="explicit run directory (evaluate/separate)")
        p.add_argument("--resume", action="store_true")
        _add_train_overrides(p)
        if name == "evaluate":
            p.add_argument("--n-mixtures", type=int, default=32)
            p.add_argument("--stoi", action="store_true",
                           help="also report STOI intelligibility (ops/stoi.py)")
            p.add_argument("--noise-snr", type=float, default=None,
                           help="corrupt the test mixtures with white noise at this SNR "
                                "(dB); metrics stay against the clean references")
            p.add_argument("--reverb-rt60", type=float, default=None,
                           help="reverberate each test source with its own synthetic RIR "
                                "at this RT60 (seconds); metrics stay against the dry "
                                "references")
        if name == "separate":
            p.add_argument("--wav", nargs="+", required=True)
            p.add_argument("--out", default="separated")
            p.add_argument("--num-speakers", default=None,
                           help="output source count: an int (clustering models separate "
                                "at any k) or 'auto' (blind per-mixture eigengap estimate, "
                                "infer/count.py); default the recipe's nb_speakers")
            p.add_argument("--max-speakers", type=int, default=4,
                           help="upper bound for --num-speakers auto")
            p.add_argument("--count-weights", default="vad",
                           choices=["vad", "magnitude", "magvad"],
                           help="bin weighting of the --num-speakers auto eigengap Gram")
            p.add_argument("--mesh-devices", type=int, default=None,
                           help="spread the chunks of over-bucket utterances over this "
                                "many cards (infer/long.py::separate_long_sharded)")
        if name == "profile":
            p.description = ("Trace --profile-steps train steps into <trace-dir>/trace.json, a "
                             "Chrome trace of the host and the card's kernels that carries the "
                             "port's spans (train.step > train.gather, train.forward with "
                             "front, trunk, head and decode, train.backward, train.optimizer > "
                             "train.clip; utils/profiling.py), and print the steps' "
                             "wall-clock statistics.")
            p.add_argument("--profile-steps", type=int, default=20)
            p.add_argument("--trace-dir", default="amss_trace",
                           help="where trace.json goes; the port's spans are among its ranges")
        if name == "sweep":
            p.add_argument("--grid", nargs="+", required=True,
                           help="axes as key=v1,v2 (flag names, e.g. lr=1e-3,3e-4 "
                                "expansion=2,4); the cartesian product is trained in turn")
            p.add_argument("--n-mixtures", type=int, default=32)
        if name == "export":
            p.add_argument("--out", required=True, help="serving-artifact output directory")
            p.add_argument("--lengths", type=int, nargs="+", default=[16384, 65536],
                           help="bucket lengths (samples) to export")
            p.add_argument("--serve-batch", type=int, default=8)
            p.add_argument("--platforms", nargs="+", choices=["cpu", "cuda"],
                           default=["cpu", "cuda"],
                           help="devices to export programs for (cuda needs a card)")
            p.add_argument("--realtime", action="store_true",
                           help="export the causal streaming step (c7-style models) "
                                "instead of offline bucket serving")
            p.add_argument("--rt-chunk", type=int, default=4096,
                           help="realtime export: samples per push")
            p.add_argument("--rt-streams", type=int, default=1,
                           help="realtime export: concurrent streams per push")
            p.add_argument("--quantize", choices=["int8"], default=None,
                           help="int8-compress the parameter blob (about 4x smaller; "
                                "infer/quantize.py; the loader dequantizes)")
        p.set_defaults(fn=fn)

    p = sub.add_parser("separate-exported",
                       help="separate WAVs through an exported artifact (no model code)")
    p.add_argument("--export-dir", required=True)
    p.add_argument("--wav", nargs="+", required=True)
    p.add_argument("--out", default="separated")
    p.set_defaults(fn=cmd_separate_exported)

    p = sub.add_parser("serve", help="HTTP serving daemon over an exported artifact")
    p.add_argument("--export-dir", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.set_defaults(fn=cmd_serve)

    args = ap.parse_args(argv)
    args.device = device
    args.fn(args)


if __name__ == "__main__":
    main()
