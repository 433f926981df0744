"""Build and pickle a vocabulary (the reference's build_vocab.py and
build_vocab_cc.py).

Port of ``captionax/cli/build_vocab.py``: the same words in the same order
for the same files.  The pickle holds the port's ``Vocab``; each package's
``load_vocab_pickle`` reads the other's.  Runs on the host only.

    python -m captionax_torch.cli.build_vocab --out data/vocab.pkl \\
        --factual data/factual_train.txt --humour ... --romantic ...
    python -m captionax_torch.cli.build_vocab --out data/vocab_CC.pkl \\
        --cc data/200_conceptual_train.txt
"""

from __future__ import annotations

import argparse
import pickle

from captionax_torch.core.vocab import build_vocab, extract_factual_caption_lines
from captionax_torch.data.cc import load_cc_captions
from captionax_torch.data.flickr import load_styled_captions


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--factual", default="")
    p.add_argument("--humour", default="")
    p.add_argument("--romantic", default="")
    p.add_argument("--cc", default="", help="CC caption file (5-space format)")
    p.add_argument("--min-count", type=int, default=2)
    args = p.parse_args(argv)

    styled = []
    for path in (args.humour, args.romantic):
        if path:
            styled.append(load_styled_captions(path))
    factual = None
    if args.factual:
        factual = extract_factual_caption_lines(args.factual)
    if args.cc:
        # the CC vocab takes every caption as one corpus, the min count
        # applied (the reference's build_vocab_cc.py keeps count >= 2)
        caps = [cap for _, cap, _ in load_cc_captions(args.cc)]
        factual = (factual or []) + caps
    vocab = build_vocab(factual, styled, min_count_factual=args.min_count)
    with open(args.out, "wb") as f:
        pickle.dump(vocab, f)
    print(f"wrote {args.out}: {len(vocab)} entries")
    return vocab


if __name__ == "__main__":
    main()
