"""End-to-end demo of the PyTorch port: batched basecalling-style decoding
on synthetic reads; the counterpart of ``examples/basecall_demo.py``.

Generates synthetic posteriors for known sequences (the shape a basecaller
network would emit), decodes them three ways (batched beam search, batched
viterbi, and duplex pair consensus) through the port's
``BatchBeamDecoder``, ``BatchViterbiDecoder`` and ``beam_search_duplex``, and
reports accuracy and throughput.  The reads are the JAX demo's (seed 0; the
duplex pair's second read from seed 1).

Runs on the card (timings between two ``torch.cuda.synchronize()``);
``--device cpu`` runs the plain engines on the CPU.  Without a card and
without ``--device`` it raises.

Run: python examples/basecall_demo_torch.py [--reads N] [--T frames] [--device cpu]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ALPHABET = "NACGT"


def synth_read(rng, n_bases, frames_per_base=6, noise=0.04):
    """Posteriors for a random sequence: each base emits once among blanks."""
    seq = rng.randint(1, 5, n_bases)
    T = n_bases * frames_per_base
    x = rng.rand(T, 5).astype(np.float32) * noise
    x[:, 0] += 2.0  # blank-heavy background
    for i, b in enumerate(seq):
        x[i * frames_per_base, b] += 8.0
    x /= x.sum(axis=1, keepdims=True)
    return "".join(ALPHABET[b] for b in seq), x


def duplex_pair(rng):
    """The JAX demo's pair: two noisy observations of one sequence of 12
    bases, the second re-emitted from ``RandomState(1)``."""
    truth, p1 = synth_read(rng, 12, noise=0.15)
    synth_read(rng, 12, noise=0.15)  # drawn and discarded, as the JAX demo does
    rng2 = np.random.RandomState(1)
    p2 = rng2.rand(*p1.shape).astype(np.float32) * 0.15
    p2[:, 0] += 2.0
    for i, ch in enumerate(truth):
        p2[i * 6, ALPHABET.index(ch)] += 8.0
    p2 /= p2.sum(axis=1, keepdims=True)
    return truth, p1, p2


def run(reads=256, T=300, device=None, log=print):
    """Decode the demo's reads; returns a dict: ``truths``, ``beam`` and
    ``viterbi`` results (warm passes), ``duplex_truth``, ``consensus``,
    ``engine`` / ``design`` (what auto picked for the beam) and
    ``reads_per_s`` (first and warm beam passes)."""
    import torch

    from fast_ctc_decode_tpu_torch import BatchBeamDecoder, BatchViterbiDecoder
    from fast_ctc_decode_tpu_torch import beam_search_duplex
    from fast_ctc_decode_tpu_torch.device import resolve_device
    from fast_ctc_decode_tpu_torch.ops import beam_cuda
    from fast_ctc_decode_tpu_torch.utils.padding import pad_batch

    dev = resolve_device(device)

    def wall(fn):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0

    rng = np.random.RandomState(0)
    n_bases = T // 6
    truths, reads_ = zip(*(synth_read(rng, n_bases) for _ in range(reads)))
    probs, lengths = pad_batch(list(reads_))
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"{reads} reads x {probs.shape[1]} frames on {dev} ({where})")

    # --- batched prefix beam search ---
    dec = BatchBeamDecoder(ALPHABET, T=probs.shape[1], beam_size=5, beam_cut_threshold=0.1,
                           device=dev)
    design = beam_cuda.design_for(reads, 5, len(ALPHABET) - 1) if dec.engine == "cuda" else None
    log(f"beam   : engine {dec.engine!r} picked by auto"
        f"{f' ({design} design: B={reads})' if design else ''}")
    results, dt = wall(lambda: dec.decode(probs, lengths))
    first = reads / dt
    acc = np.mean([r[0] == t for r, t in zip(results, truths)])
    log(f"beam   : {acc:6.1%} exact reads, {first:8.0f} reads/s "
        f"(first call)")
    results, dt = wall(lambda: dec.decode(probs, lengths))
    log(f"beam   : warm pass            {reads / dt:8.0f} reads/s")

    # --- batched viterbi ---
    vit = BatchViterbiDecoder(ALPHABET, T=probs.shape[1], device=dev)
    vres = vit.decode(probs, lengths)
    vres = vit.decode(probs, lengths)
    vacc = np.mean([r[0] == t for r, t in zip(vres, truths)])
    log(f"viterbi: {vacc:6.1%} exact reads")

    # --- duplex consensus of two noisy observations of the same sequence ---
    truth, p1, p2 = duplex_pair(rng)
    consensus = beam_search_duplex(p1, p2, ALPHABET, device=dev)
    log(f"duplex : truth {truth} -> consensus {consensus} "
        f"({'exact' if consensus == truth else 'diff'})")
    return {
        "truths": list(truths), "beam": results, "viterbi": vres,
        "duplex_truth": truth, "consensus": consensus,
        "engine": dec.engine, "design": design, "reads_per_s": (first, reads / dt),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=256)
    ap.add_argument("--T", type=int, default=300)
    ap.add_argument("--device", default=None, help="cpu for the plain engines on the CPU")
    args = ap.parse_args(argv)
    return run(args.reads, args.T, args.device)


if __name__ == "__main__":
    main()
