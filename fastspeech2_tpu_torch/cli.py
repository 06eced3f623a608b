"""Command-line entry points of the port (``fastspeech2_tpu/cli.py``):

    python -m fastspeech2_tpu_torch preprocess -d WAV_DIR -c CONFIG [--device cpu]
    python -m fastspeech2_tpu_torch stats -c CONFIG [-d DATA_DIR]
    python -m fastspeech2_tpu_torch train -c CONFIG -n NAME -o OUTDIR [-p CKPT] [--device cpu]
    python -m fastspeech2_tpu_torch evaluate -p CKPT [-c CONFIG] [--device cpu]
    python -m fastspeech2_tpu_torch average CKPT CKPT ... -o OUT.npz [--device cpu]
    python -m fastspeech2_tpu_torch gta -p CKPT -o OUT_DIR [--filelist FL] [--device cpu]
    python -m fastspeech2_tpu_torch convert -p SRC -o DST [-c CONFIG] [--device cpu]
    python -m fastspeech2_tpu_torch synth -p CKPT --text "..." [--phonemes] -o OUT [--int8]
        [--precision {default,highest}] [--vocoder VOC] [--device cpu]
    python -m fastspeech2_tpu_torch serve -p CKPT [--port 8000] [--warmup] [--int8]
        [--vocoder VOC] [--device cpu]
    python -m fastspeech2_tpu_torch golden [-p CKPT.pth] [--text "..."] [--phonemes "A B|C D"]
        [--golden MEL.npy] [--vocoder VOC --golden_wav WAV --out_wav OUT.wav] [--device cpu]
    python -m fastspeech2_tpu_torch export [-p CKPT] [-c CONFIG] -o OUT.pt2 [--batch 1]
        [--max_tokens 192] [--max_frames 1024] [--bf16] [--precision {default,highest}]
        [--int8] [--vocoder MELGAN] [--device cpu]

``preprocess`` turns a folder of wavs into the feature store that
``data/dataset.py`` and ``train`` read (``mels/``, ``energy/``, ``pitch/``
.npy per utterance); ``stats`` prints the energy and pitch statistics of that
store for the config's ``data:`` section. ``train`` runs
``train/loop.py:train`` (``-p`` resumes), ``evaluate`` prints the predictors'
teacher-forced L1 losses on the validation set, ``average`` writes the
uniform average of checkpoints, ``gta`` dumps ground-truth-aligned mels for a
vocoder (``train/gta.py``), and ``convert`` moves weights between the
``.npz`` checkpoints and the reference's ``.pth``/``.pyt`` format by file
extension (``compat/``). ``synth`` writes one sentence's mel (``mel.npy``,
(n_mels, L)) and wav (``test_tts.wav``, Griffin-Lim or ``--vocoder`` MelGAN)
in the f32 tier, from a ``.npz`` checkpoint of either package or a reference
``.pth``; ``serve`` runs the micro-batching HTTP server (``infer/server.py``),
bf16 on the card, from a ``.npz`` only (as the JAX package's ``serve``). Both
build a seeded random model from ``-c`` without ``-p``, take ``--int8`` (the
W8A8 tier, ``ops/quant8.py``) and a MelGAN or WaveGlow ``--vocoder``;
``synth --precision default`` lets its f32 products use TF32. ``golden``
synthesizes the reference's README sentence from a released reference
checkpoint in the f32 parity tier and reports its distance to the
reference's golden mel, or with ``--vocoder`` to its published sample wav
(``compat/golden.py``). ``export`` traces the inference function with its
weights baked in through ``torch.export`` (``infer/export.py``; the serving
kernels as custom ops) into a ``.pt2`` artifact that ``load_exported``
calls. Every command but ``stats`` takes ``--device``: the card unless
``--device cpu`` is given, and without a GPU it raises.

``train`` and ``serve`` also run under ``python -m torch.distributed.run
--nproc_per_node N -m fastspeech2_tpu_torch ...``: one rank per device,
NCCL on the cards unless ``--backend gloo`` is given (several ranks on one
card), gloo on the CPU. ``train`` then trains its part of the (dp, tp) mesh
(``train.dp_size``, ``train.tensor_parallel``, ``train.sequence_parallel``,
``train/loop.py``); ``serve`` answers on rank 0 and shards each batch over
the ranks (``infer/synthesize.py``). A single ``serve`` process shards over
every local card when there are several.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import logging
import os

import numpy as np

#: wavs read, featurised and written per pass of ``preprocess``
CHUNK = 64


def read_wav_float(path: str, sample_rate: int, peak_norm: bool = False) -> np.ndarray:
    """16/32-bit PCM or float wav -> float32 in [-1, 1], checked against the
    config's sample rate; optionally normalised to the file's peak."""
    from scipy.io.wavfile import read as read_wav

    sr, wav = read_wav(path)
    if wav.dtype == np.int16:
        wav = wav / 32768.0
    elif wav.dtype == np.int32:
        wav = wav / 2147483648.0
    assert sr == sample_rate, f"{path}: sr {sr} != {sample_rate}"
    wav = wav.astype(np.float32)
    if peak_norm:  # normalise to the peak of each wav file
        peak = np.abs(wav).max()
        if peak > 0:
            wav = wav / peak
    return wav


def cmd_preprocess(args):
    """wav -> (mel, energy, pitch) .npy per utterance (nvidia_preprocessing.py).

    Mel and energy run in length-bucketed batches on ``--device`` (kernel 14
    on the card); pitch is per-utterance host DIO, cut to the mel length."""
    from fastspeech2_tpu_torch.audio.pitch import extract_pitch
    from fastspeech2_tpu_torch.audio.stft import MelSpectrogram
    from fastspeech2_tpu_torch.config import load_config

    cfg = load_config(args.config)
    a = cfg.audio
    mel_fn = MelSpectrogram(a.sample_rate, a.n_fft, a.hop_length, a.win_length,
                            a.n_mels, a.fmin, a.fmax, device=args.device)
    out_root = args.out or cfg.data.data_dir
    for sub in ("mels", "energy", "pitch"):
        os.makedirs(os.path.join(out_root, sub), exist_ok=True)
    # -d overrides; otherwise data.wav_dir from the config
    wav_root = args.data_path or cfg.data.wav_dir
    wavs = sorted(glob.glob(os.path.join(wav_root, "**", "*.wav"), recursive=True))
    if not wavs:
        # exiting 0 with empty mels/energy/pitch dirs would surface much
        # later as an inexplicably empty feature store at train time
        raise SystemExit(
            f"preprocess: no .wav files under {wav_root!r} "
            "(pass -d or set data.wav_dir in the config)")
    logging.info("preprocessing %d wavs -> %s on %s", len(wavs), out_root,
                 mel_fn.device)
    for c in range(0, len(wavs), CHUNK):
        paths = wavs[c : c + CHUNK]
        signals = [read_wav_float(p, a.sample_rate, a.peak_norm) for p in paths]
        feats = mel_fn.mel_and_energy_bucketed(signals)
        for path, wav, (mel, e) in zip(paths, signals, feats):
            p = extract_pitch(wav, a.sample_rate, a.hop_length)
            p = p[: mel.shape[1]]
            utt = os.path.basename(path).split(".")[0]
            np.save(os.path.join(out_root, "mels", f"{utt}.npy"), mel)
            np.save(os.path.join(out_root, "energy", f"{utt}.npy"), e)
            np.save(os.path.join(out_root, "pitch", f"{utt}.npy"), p.astype(np.float64))


def cmd_stats(args):
    """Dataset energy/pitch statistics to paste into the config
    (compute_statistics.py): mean/std over nonzero values after the outlier
    filter, the nonzero minima, the maxima; the means and stds also land in
    the store as ``{e,f0}_{mean,std}.npy``."""
    from fastspeech2_tpu_torch.config import load_config
    from fastspeech2_tpu_torch.data.dataset import remove_outlier

    cfg = load_config(args.config)
    root = args.data_dir or cfg.data.data_dir
    out = {}
    for kind, mean_key, cfg_key in (("energy", "e", "e"), ("pitch", "f0", "p")):
        vecs = []
        for f in sorted(glob.glob(os.path.join(root, kind, "*.npy"))):
            vecs.append(remove_outlier(np.load(f)))
        if not vecs:
            logging.warning("no %s files under %s", kind, root)
            continue
        nz = np.concatenate([v[v != 0.0] for v in vecs])
        if nz.size == 0:
            logging.warning("all %s values zero after outlier filtering", kind)
            continue
        out[f"{mean_key}_mean"] = float(nz.mean())
        out[f"{mean_key}_std"] = float(nz.std())
        out[f"{cfg_key}_min"] = float(min(v[v > 0].min() for v in vecs if (v > 0).any()))
        out[f"{cfg_key}_max"] = float(max(v.max() for v in vecs))
        np.save(os.path.join(root, f"{mean_key}_mean.npy"), np.float32(out[f"{mean_key}_mean"]))
        np.save(os.path.join(root, f"{mean_key}_std.npy"), np.float32(out[f"{mean_key}_std"]))
    # drift check: a large mismatch means the config was written for another
    # dataset than the store, and the pitch/energy bin edges would be wrong
    d = cfg.data
    for key, cfg_val in (("e_mean", d.e_mean), ("e_std", d.e_std),
                         ("f0_mean", d.f0_mean), ("f0_std", d.f0_std),
                         ("e_min", d.e_min), ("e_max", d.e_max),
                         ("p_min", d.p_min), ("p_max", d.p_max)):
        if key in out and cfg_val and \
                abs(out[key] - cfg_val) > 0.25 * max(abs(cfg_val), 1e-6):
            logging.warning(
                "config data.%s=%.4g but this dataset measures %.4g "
                "(>25%% off) -- update the data: section or the "
                "pitch/energy bins will misquantize", key, cfg_val, out[key])
    print(json.dumps(out, indent=1))


@contextlib.contextmanager
def _log_to_file(outdir: str, name: str):
    """Also log to ``outdir/name.log`` (the JAX command's run log)."""
    os.makedirs(outdir, exist_ok=True)
    root = logging.getLogger()
    root.setLevel(logging.INFO)
    handler = logging.FileHandler(os.path.join(outdir, f"{name}.log"))
    handler.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
    root.addHandler(handler)
    try:
        yield
    finally:
        root.removeHandler(handler)
        handler.close()


def _config(args):
    """The ``-c`` config, else the one embedded in the ``.npz`` checkpoint."""
    from fastspeech2_tpu_torch.config import Config, load_config
    from fastspeech2_tpu_torch.train.checkpoint import load_checkpoint_meta

    if args.config:
        return load_config(args.config)
    return Config.from_yaml(load_checkpoint_meta(args.checkpoint_path)["hp_yaml"])


def _load_model(args, device, reference_format: bool):
    """(cfg, model on ``device``): ``train/checkpoint.py:load_model`` of
    ``-p`` and ``-c`` (a ``.npz`` checkpoint of either package, a reference
    ``.pth``/``.pyt``/``.pt`` where ``reference_format``, else a random init
    from seed 0 of the ``-c`` config for smoke runs)."""
    from fastspeech2_tpu_torch.train.checkpoint import TORCH_EXTS, load_model

    path = args.checkpoint_path
    if path and path.endswith(TORCH_EXTS) and not reference_format:
        raise SystemExit(
            f"{path}: serve reads .npz checkpoints only, as the JAX package's serve "
            f"does; convert it first: python -m fastspeech2_tpu_torch convert -p {path} "
            "-o model.npz")
    return load_model(path, args.config, device)


def _join_group(args, device) -> bool:
    """Join the process group that ``python -m torch.distributed.run`` set
    up (``WORLD_SIZE`` > 1) with ``--backend`` (default: NCCL on the card,
    gloo on the CPU); returns whether this call formed it."""
    import torch.distributed as dist

    from fastspeech2_tpu_torch.parallel.mesh import initialize_multihost

    if dist.is_initialized():
        return False
    return initialize_multihost(backend=args.backend, device=device) > 1


def cmd_train(args):
    """``train/loop.py:train`` from a config (train_fastspeech.py); ``-p``
    resumes. On the card the run ends with the kernels' launch counts. Under
    ``python -m torch.distributed.run`` every rank trains its part of the
    (dp, tp) mesh (``train.dp_size``, ``train.tensor_parallel``)."""
    import torch.distributed as dist

    from fastspeech2_tpu_torch.config import load_config
    from fastspeech2_tpu_torch.device import resolve_device
    from fastspeech2_tpu_torch.ops.kernels import launch_counts
    from fastspeech2_tpu_torch.parallel.mesh import local_device
    from fastspeech2_tpu_torch.train.loop import train

    device = local_device(resolve_device(args.device))
    formed = _join_group(args, device)
    try:
        with _log_to_file(args.outdir, args.name):
            train(load_config(args.config), args.name, args.outdir,
                  resume_path=args.checkpoint_path, max_steps=args.max_steps,
                  data_dir=args.data_dir, profile_dir=args.profile_dir, device=device)
            if device.type == "cuda":
                logging.info("kernel launches: %s", json.dumps(launch_counts()))
    finally:
        if formed:
            dist.destroy_process_group()


def cmd_evaluate(args):
    """Teacher-forced L1 of the duration, energy and pitch predictions over
    the validation set (evaluation.py), printed as JSON."""
    from fastspeech2_tpu_torch.data.dataset import TTSDataset
    from fastspeech2_tpu_torch.device import resolve_device
    from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
    from fastspeech2_tpu_torch.train.checkpoint import load_checkpoint
    from fastspeech2_tpu_torch.train.loop import evaluate_predictors

    device = resolve_device(args.device)
    model = FastSpeech2(_config(args), device=device)
    _, cfg = load_checkpoint(args.checkpoint_path, model)
    valid = TTSDataset(args.data_dir or cfg.data.data_dir, cfg.data.valid_filelist,
                       cfg.train.use_phonemes, cfg.data.tts_cleaner_names)
    print(json.dumps(evaluate_predictors(model, valid), indent=1))


def cmd_gta(args):
    """Ground-truth-aligned mels, (n_mels, L) .npy per utterance, for vocoder
    finetuning (train/gta.py)."""
    from fastspeech2_tpu_torch.data.dataset import TTSDataset
    from fastspeech2_tpu_torch.device import resolve_device
    from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
    from fastspeech2_tpu_torch.train.checkpoint import load_checkpoint
    from fastspeech2_tpu_torch.train.gta import generate_gta

    device = resolve_device(args.device)
    model = FastSpeech2(_config(args), device=device)
    _, cfg = load_checkpoint(args.checkpoint_path, model)
    ds = TTSDataset(args.data_dir or cfg.data.data_dir,
                    args.filelist or cfg.data.train_filelist,
                    cfg.train.use_phonemes, cfg.data.tts_cleaner_names)
    generate_gta(model, ds, args.out)


def cmd_convert(args):
    """Checkpoint conversion by extension: .npz <-> .pth/.pyt (compat/), so
    models trained here deploy on the reference and back."""
    from fastspeech2_tpu_torch.config import Config, load_config
    from fastspeech2_tpu_torch.device import resolve_device
    from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
    from fastspeech2_tpu_torch.train.checkpoint import (TORCH_EXTS, load_checkpoint,
                                                        load_checkpoint_meta,
                                                        save_checkpoint)

    device = resolve_device(args.device)
    src, dst = args.checkpoint_path, args.out
    if src.endswith(".npz") and dst.endswith(TORCH_EXTS):
        from fastspeech2_tpu_torch.compat.torch_saver import save_torch_checkpoint

        cfg = Config.from_yaml(load_checkpoint_meta(src)["hp_yaml"])
        model = FastSpeech2(cfg, device=device)
        step, _ = load_checkpoint(src, model)
        save_torch_checkpoint(dst, model, cfg, step=step)
        logging.info("wrote reference-format checkpoint %s (step %d)", dst, step)
    elif src.endswith(TORCH_EXTS) and dst.endswith(".npz"):
        from fastspeech2_tpu_torch.compat.torch_loader import load_torch_model

        cfg, step, model = load_torch_model(
            src, load_config(args.config) if args.config else None, device)
        save_checkpoint(dst, model, None, step, cfg)
        logging.info("wrote native checkpoint %s (step %d)", dst, step)
    else:
        raise SystemExit(
            f"unsupported conversion {src} -> {dst}: use .npz <-> .pth/.pyt")


def cmd_average(args):
    """Uniform average of N same-config checkpoints into one deployment
    checkpoint (train/checkpoint.py:average_checkpoints). The average is
    taken in float64 on the host whatever the device."""
    from fastspeech2_tpu_torch.device import resolve_device
    from fastspeech2_tpu_torch.train.checkpoint import average_checkpoints

    resolve_device(args.device)
    if len(args.checkpoints) < 2:  # a 1-file glob is a usage error, not a bug
        raise SystemExit("average: need at least 2 checkpoints "
                         f"(got {args.checkpoints})")
    step = average_checkpoints(args.checkpoints, args.out)
    logging.info("wrote %s (uniform average of %d checkpoints, step %d)",
                 args.out, len(args.checkpoints), step)


def cmd_synth(args):
    """One sentence -> mel.npy (n_mels, L) and test_tts.wav (inference.py),
    in the f32 tier: the Synthesizer gets no bf16, so no kernel runs."""
    from fastspeech2_tpu_torch.device import resolve_device
    from fastspeech2_tpu_torch.infer.synthesize import Synthesizer, vocode, write_wav

    device = resolve_device(args.device)
    cfg, model = _load_model(args, device, reference_format=True)
    synth = Synthesizer(model, device=device, matmul_precision=args.precision,
                        int8=args.int8)
    if args.phonemes:
        mel = synth.synth_phonemes(args.text, alpha=args.alpha)
        stats = {"frames": int(mel.shape[0])}
    else:
        mel, stats = synth.synth_text(args.text, alpha=args.alpha)
    logging.info("synthesized %s frames (%s)", mel.shape[0], stats)
    os.makedirs(args.out, exist_ok=True)
    np.save(os.path.join(args.out, "mel.npy"), mel.T)  # (n_mels, L) like the ref
    try:  # mel.png artifact (reference inference.py:177-178); best-effort
        from fastspeech2_tpu_torch.utils.plotting import save_spectrogram_png

        save_spectrogram_png(mel.T, os.path.join(args.out, "mel.png"))
    except Exception as exc:
        logging.warning("mel.png not written: %s", exc)
    vocoder = None
    vocoder_path = args.vocoder or cfg.train.vocoder_checkpoint
    if vocoder_path:
        from fastspeech2_tpu_torch.vocoder import detect_vocoder_kind, load_vocoder

        kind = detect_vocoder_kind(vocoder_path)
        vocoder = load_vocoder(vocoder_path, kind=kind, device=device)
        logging.info("vocoding with %s checkpoint %s", kind, vocoder_path)
    wav = vocode(mel, cfg, vocoder=vocoder, device=device)
    write_wav(os.path.join(args.out, "test_tts.wav"), wav, cfg.audio.sample_rate)
    logging.info("wrote %s", os.path.join(args.out, "test_tts.wav"))


def cmd_golden(args):
    """Released-checkpoint golden comparison (``compat/golden.py``): load a
    reference .pth/.pyt, synthesize the README sentence as the reference's
    inference.py does, and print the MAE against
    sample/generated_mel_58k.npy as JSON; with ``--vocoder``, the fused
    text->wav path's spectral distance to the published sample wav."""
    from fastspeech2_tpu_torch.compat.golden import (GOLDEN_TEXT, GOLDEN_WAVS,
                                                     compare_to_golden,
                                                     compare_to_golden_wav,
                                                     find_released_checkpoint,
                                                     synth_wav_with_torch_checkpoints,
                                                     synth_with_torch_checkpoint)
    from fastspeech2_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    ckpt = args.checkpoint_path or find_released_checkpoint()
    if not ckpt:
        raise SystemExit(
            "no released checkpoint found: pass -p, set FS2_RELEASED_CKPT, "
            "or drop one under checkpoints/released/")
    phoneme_strs = args.phonemes.split("|") if args.phonemes else None
    text = args.text or GOLDEN_TEXT
    if args.vocoder:
        from fastspeech2_tpu_torch.vocoder import detect_vocoder_kind

        kind = detect_vocoder_kind(args.vocoder)
        if not (args.golden_wav or GOLDEN_WAVS.get(kind)):
            raise SystemExit("no golden wav: pass --golden_wav or set FS2_REFERENCE_DIR")
        wav, sr, step = synth_wav_with_torch_checkpoints(
            ckpt, args.vocoder, kind=kind, text=text, phoneme_strs=phoneme_strs,
            device=device)
        if args.out_wav:
            from scipy.io.wavfile import write as write_wav

            write_wav(args.out_wav, sr, (np.clip(wav, -1.0, 1.0) * 32767).astype(np.int16))
        report = compare_to_golden_wav(wav, sr, kind, golden_path=args.golden_wav,
                                       device=device)
        report.update(ckpt=ckpt, vocoder=args.vocoder, kind=kind, step=step)
        if args.out_wav:
            report["out_wav"] = args.out_wav
    else:
        if not args.golden:
            raise SystemExit("no golden mel: pass --golden or set FS2_REFERENCE_DIR")
        mel, _, step = synth_with_torch_checkpoint(ckpt, text=text,
                                                   phoneme_strs=phoneme_strs,
                                                   device=device)
        report = compare_to_golden(mel, args.golden)
        report.update(ckpt=ckpt, step=step)
    print(json.dumps(report, indent=1))


def cmd_export(args):
    """The inference function with its weights baked in, traced by
    ``torch.export`` for a fixed (batch, max_tokens, max_frames) signature
    (``infer/export.py``); ``--vocoder`` bakes a MelGAN in."""
    from fastspeech2_tpu_torch.infer.export import export_inference

    export_inference(args.checkpoint_path, args.out, config_path=args.config,
                     batch=args.batch, max_tokens=args.max_tokens,
                     max_frames=args.max_frames, bf16=args.bf16,
                     matmul_precision=args.precision, int8=args.int8,
                     vocoder_path=args.vocoder, device=args.device)


def cmd_serve(args):
    """Micro-batching HTTP synthesis server (infer/server.py), bf16 on the
    card; blocks until the process is stopped. Data-parallel over every
    local card when there are several (JAX ``cli.py:260-267``); under
    ``python -m torch.distributed.run`` over the ranks, rank 0 taking the
    requests and the others serving their shards of each batch."""
    import time

    import torch
    import torch.distributed as dist

    from fastspeech2_tpu_torch.device import resolve_device
    from fastspeech2_tpu_torch.infer.server import serve
    from fastspeech2_tpu_torch.infer.synthesize import Synthesizer
    from fastspeech2_tpu_torch.parallel.mesh import local_device, make_mesh

    device = local_device(resolve_device(args.device))
    formed = _join_group(args, device)
    cfg, model = _load_model(args, device, reference_format=False)
    on_card = device.type == "cuda"
    mesh = None
    if dist.is_initialized() and dist.get_world_size() > 1:
        mesh = make_mesh(device=device)
        logging.info("serving data-parallel over %d ranks (rank %d)", mesh.size,
                     dist.get_rank())
    elif on_card and torch.cuda.device_count() > 1:
        mesh = make_mesh(torch.cuda.device_count())
        logging.info("serving data-parallel over %d cards, one thread a card%s", mesh.size,
                     " (int8: one activation scale over all of them)" if args.int8 else "")
    synth = Synthesizer(model, bf16=on_card, device=device, int8=args.int8, mesh=mesh)
    vocoder_path = args.vocoder or cfg.train.vocoder_checkpoint
    if vocoder_path:
        from fastspeech2_tpu_torch.vocoder import (detect_vocoder_kind, load_melgan_params,
                                                   load_waveglow)

        kind = detect_vocoder_kind(vocoder_path)
        if kind == "melgan":
            # fused text->wav: MelGAN runs on the device right after the model
            synth.attach_vocoder(load_melgan_params(vocoder_path, bf16=on_card, device=device))
            logging.info("serving wav fused with MelGAN checkpoint %s", vocoder_path)
        else:
            # WaveGlow draws noise per request: it runs after the acoustic
            # model on the finished mels, not fused
            synth.attach_vocoder_fn(load_waveglow(vocoder_path, bf16=on_card, device=device))
            logging.info("serving wav with WaveGlow checkpoint %s", vocoder_path)
    if args.warmup:
        t0 = time.perf_counter()
        n = synth.warmup(batch_sizes=(1, args.max_batch))
        logging.info("warmed %d serving shapes in %.1fs", n, time.perf_counter() - t0)
    try:
        if mesh is not None and mesh.distributed and dist.get_rank() != 0:
            synth.follow()
            return
        if mesh is not None and mesh.distributed:
            synth.lead()
        try:
            serve(synth, cfg, host=args.host, port=args.port, max_batch=args.max_batch,
                  max_wait_ms=args.max_wait_ms)
        finally:
            synth.stop_followers()
    finally:
        if formed:
            dist.destroy_process_group()


def main(argv=None):
    p = argparse.ArgumentParser(prog="fastspeech2_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("preprocess")
    sp.add_argument("-d", "--data_path", default=None,
                    help="wav root; defaults to data.wav_dir from the config")
    sp.add_argument("-c", "--config", default=None)
    sp.add_argument("-o", "--out", default=None)
    sp.add_argument("--device", default=None,
                    help="torch device of the mel/energy batches (default: cuda)")
    sp.set_defaults(fn=cmd_preprocess)

    sp = sub.add_parser("stats")
    sp.add_argument("-c", "--config", default=None)
    sp.add_argument("-d", "--data_dir", default=None)
    sp.set_defaults(fn=cmd_stats)

    sp = sub.add_parser("train")
    sp.add_argument("-c", "--config", default=None)
    sp.add_argument("-n", "--name", default="fastspeech2")
    sp.add_argument("-o", "--outdir", default="./out")
    sp.add_argument("-p", "--checkpoint_path", default=None,
                    help=".npz checkpoint of either package to resume from")
    sp.add_argument("-d", "--data_dir", default=None)
    sp.add_argument("--max_steps", type=int, default=None)
    sp.add_argument("--profile_dir", default=None,
                    help="write a torch.profiler Chrome trace of a few warm steps here")
    sp.add_argument("--device", default=None, help="torch device (default: cuda)")
    sp.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="process-group backend under torch.distributed.run "
                         "(default: nccl on the card, gloo on the CPU; gloo "
                         "lets several ranks share one card)")
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("gta")
    sp.add_argument("-p", "--checkpoint_path", required=True)
    sp.add_argument("-c", "--config", default=None)
    sp.add_argument("-d", "--data_dir", default=None)
    sp.add_argument("--filelist", default=None)
    sp.add_argument("-o", "--out", required=True)
    sp.add_argument("--device", default=None, help="torch device (default: cuda)")
    sp.set_defaults(fn=cmd_gta)

    sp = sub.add_parser("synth")
    sp.add_argument("-p", "--checkpoint_path", default=None,
                    help=".npz checkpoint (its embedded config is used) or a "
                         "reference .pth/.pyt (config from -c, else its hp_str)")
    sp.add_argument("-c", "--config", default=None,
                    help="config of a random init from seed 0 (without -p)")
    sp.add_argument("--text", required=True)
    sp.add_argument("--phonemes", action="store_true",
                    help="treat --text as a space-joined phoneme string")
    sp.add_argument("--alpha", type=float, default=1.0)
    sp.add_argument("--int8", action="store_true",
                    help="W8A8 int8 serving: quantize encoder/decoder matmul "
                         "weights to int8")
    sp.add_argument("--precision", default="highest",
                    choices=("default", "highest"),
                    help="matmul precision for f32 inference; 'highest' keeps "
                         "f32 products in full f32 for reference-grade mel "
                         "parity, 'default' lets them use TF32 (no-op on CPU)")
    sp.add_argument("--vocoder", default=None,
                    help="local seungwonpark-format MelGAN or NVIDIA-format "
                         "WaveGlow checkpoint (else Griffin-Lim)")
    sp.add_argument("-o", "--out", default="./synth_out")
    sp.add_argument("--device", default=None, help="torch device (default: cuda)")
    sp.set_defaults(fn=cmd_synth)

    sp = sub.add_parser("serve")
    sp.add_argument("-p", "--checkpoint_path", default=None,
                    help=".npz checkpoint; its embedded config is used")
    sp.add_argument("-c", "--config", default=None,
                    help="config of a random init from seed 0 (without -p)")
    sp.add_argument("--host", default="0.0.0.0")
    sp.add_argument("--port", type=int, default=8000)
    sp.add_argument("--max_batch", type=int, default=16)
    sp.add_argument("--max_wait_ms", type=float, default=5.0)
    sp.add_argument("--int8", action="store_true",
                    help="W8A8 int8 serving for the acoustic model")
    sp.add_argument("--vocoder", default=None,
                    help="local MelGAN or WaveGlow checkpoint for wav "
                         "responses (else Griffin-Lim)")
    sp.add_argument("--warmup", action="store_true",
                    help="run every pow2 batch bucket up to --max_batch at "
                         "common token lengths before binding the port")
    sp.add_argument("--device", default=None,
                    help="torch device (default: cuda, in bf16; cpu runs f32)")
    sp.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="process-group backend under torch.distributed.run "
                         "(default: nccl on the card, gloo on the CPU)")
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("evaluate")
    sp.add_argument("-p", "--checkpoint_path", required=True)
    sp.add_argument("-c", "--config", default=None)
    sp.add_argument("-d", "--data_dir", default=None)
    sp.add_argument("--device", default=None, help="torch device (default: cuda)")
    sp.set_defaults(fn=cmd_evaluate)

    sp = sub.add_parser("convert")
    sp.add_argument("-p", "--checkpoint_path", required=True)
    sp.add_argument("-o", "--out", required=True)
    sp.add_argument("-c", "--config", default=None,
                    help="override config for .pth sources (default: the "
                         "checkpoint's embedded hp_str)")
    sp.add_argument("--device", default=None, help="torch device (default: cuda)")
    sp.set_defaults(fn=cmd_convert)

    sp = sub.add_parser("average")
    sp.add_argument("checkpoints", nargs="+",
                    help="two or more .npz checkpoints of the same config")
    sp.add_argument("-o", "--out", required=True)
    sp.add_argument("--device", default=None, help="torch device (default: cuda)")
    sp.set_defaults(fn=cmd_average)

    sp = sub.add_parser("golden")
    sp.add_argument("-p", "--checkpoint_path", default=None,
                    help="released reference .pth/.pyt (default: search "
                         "FS2_RELEASED_CKPT / checkpoints/released/)")
    sp.add_argument("--text", default=None,
                    help="input text (default: the README golden sentence)")
    sp.add_argument("--phonemes", default=None,
                    help="'|'-separated per-sentence phoneme strings to "
                         "bypass g2p (reproduce the exact 2020 g2p_en "
                         "tokenization)")
    from fastspeech2_tpu_torch.compat.golden import GOLDEN_MEL_PATH

    sp.add_argument("--golden", default=GOLDEN_MEL_PATH,
                    help="golden mel .npy (default: the reference tree's, "
                         "from FS2_REFERENCE_DIR)")
    sp.add_argument("--vocoder", default=None,
                    help="MelGAN/WaveGlow checkpoint: compare the fused "
                         "text->wav output against the published sample wav "
                         "instead of the golden mel")
    sp.add_argument("--golden_wav", default=None,
                    help="override the published sample wav to compare "
                         "against (default: sample_74k_{melgan,waveglow}.wav)")
    sp.add_argument("--out_wav", default=None,
                    help="also write the synthesized wav here")
    sp.add_argument("--device", default=None, help="torch device (default: cuda)")
    sp.set_defaults(fn=cmd_golden)

    sp = sub.add_parser("export")
    sp.add_argument("-p", "--checkpoint_path", default=None)
    sp.add_argument("-c", "--config", default=None)
    sp.add_argument("-o", "--out", required=True)
    sp.add_argument("--batch", type=int, default=1)
    sp.add_argument("--max_tokens", type=int, default=192)
    sp.add_argument("--max_frames", type=int, default=1024)
    sp.add_argument("--bf16", action="store_true",
                    help="bake the bf16 tier (the serving kernels on the card) "
                         "into the artifact")
    sp.add_argument("--precision", default="default",
                    choices=("default", "highest"),
                    help="matmul precision of the artifact's f32 products on "
                         "the card; 'highest' = full f32 (the parity tier)")
    sp.add_argument("--int8", action="store_true",
                    help="bake W8A8 int8 encoder/decoder matmuls into the "
                         "artifact")
    sp.add_argument("--vocoder", default=None,
                    help="MelGAN checkpoint to bake in: the artifact then "
                         "emits (mel, wav int16, out_lens) as one graph")
    sp.add_argument("--device", default=None,
                    help="torch device the artifact is traced for and runs on "
                         "(default: cuda)")
    sp.set_defaults(fn=cmd_export)

    args = p.parse_args(argv)
    args.fn(args)
