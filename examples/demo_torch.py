"""End-to-end walkthrough of the PyTorch port (``examples/demo.py`` through
``fastspeech2_tpu_torch``): dataset -> training -> checkpoint reload ->
synthesis -> wav.

Runs hermetically with a synthetic feature store, on the card by default or
on the CPU with ``--device cpu``; swap in a real LJSpeech feature store
(``python -m fastspeech2_tpu_torch preprocess``) and a reference checkpoint
(``compat/torch_loader.py``) for real speech.

    python examples/demo_torch.py [--workdir DIR] [--steps 12] [--device cpu]
"""

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir",
                    default=os.path.join(tempfile.gettempdir(), "fs2_demo_torch"))
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the plain versions)")
    args = ap.parse_args()
    os.makedirs(args.workdir, exist_ok=True)

    from fastspeech2_tpu_torch.config import Config, config_from_dict
    from fastspeech2_tpu_torch.data.dataset import write_fake_feature_store
    from fastspeech2_tpu_torch.device import resolve_device
    from fastspeech2_tpu_torch.infer.synthesize import Synthesizer, vocode, write_wav
    from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
    from fastspeech2_tpu_torch.train.checkpoint import load_checkpoint
    from fastspeech2_tpu_torch.train.loop import train

    device = resolve_device(args.device)

    # 1. a tiny dataset + config (use `preprocess` + `stats` for real data)
    data = os.path.join(args.workdir, "data")
    filelist = write_fake_feature_store(data, n_utts=16, seed=0)
    d = Config().to_dict()
    d["model"].update(adim=64, ddim=64, aheads=2, elayers=2, dlayers=2,
                      eunits=128, dunits=128)
    d["data"].update(data_dir=data, train_filelist=filelist,
                     valid_filelist=filelist)
    d["train"].update(batch_size=4, accum_grad=1, summary_interval=4,
                      validation_step=10 ** 9, save_interval=args.steps)
    cfg = config_from_dict(d)

    # 2. train a few steps
    ts = train(cfg, "demo", args.workdir, max_steps=args.steps, device=device)
    print(f"trained {int(ts.step)} steps on {device}")

    # 3. reload the checkpoint the way deployment would
    ckpts = sorted(os.listdir(os.path.join(args.workdir, "checkpoints", "demo")))
    path = os.path.join(args.workdir, "checkpoints", "demo", ckpts[-1])
    model = FastSpeech2(cfg, device=device)
    step, cfg = load_checkpoint(path, model)
    print(f"loaded {path} (step {step})")

    # 4. synthesize: phonemes -> mel -> Griffin-Lim wav (pass a MelGAN
    #    checkpoint to vocode() for neural vocoding)
    synth = Synthesizer(model, device=device)
    mel = synth.synth_phonemes("HH AH L OW W ER L D")  # (L, 80)
    np.save(os.path.join(args.workdir, "mel.npy"), mel.T)  # (80, L) like ref
    wav = vocode(mel, cfg, device=device)
    write_wav(os.path.join(args.workdir, "demo.wav"), wav, cfg.audio.sample_rate)
    print(f"mel {mel.T.shape} -> {args.workdir}/demo.wav")


if __name__ == "__main__":
    main()
