"""Dataset preprocessing utilities (text side).

Port of ``captionax/cli/preprocess.py``: for the same inputs each
subcommand writes the same bytes.  Subcommand equivalents of the
reference's preprocessing scripts:
- ``flickr-select``    — keep the factual captions of the images that have
  styled captions (the FlickrStyle 7k subset) and write a random held-out
  test list;
- ``cc-split``         — per-domain val/test split of a CC caption file
  into separate files;
- ``merge-all``        — merge Flickr and CC captions into one file (the
  5-space format, the styles as pseudo-domains);
- ``analyze-domains``  — domain frequency counts;
- ``gcc-select``       — filter a GCC TSV down to per-domain caption rows
  and a ``.urls`` download manifest;
- ``gcc-download``     — fetch that manifest into an image tree (threaded,
  resumable; ``file://`` URLs work without a network);
- ``shuffle``          — deterministic line shuffling.

Runs on the host only.

    python -m captionax_torch.cli.preprocess cc-split --captions cc.txt \\
        --out-prefix data/cc
"""

from __future__ import annotations

import argparse
import random
from collections import Counter

from captionax_torch.data.cc import SEP, extract_domain, load_cc_captions
from captionax_torch.data.flickr import load_factual_captions


def flickr_select(args):
    rows = load_factual_captions(args.factual)
    with open(args.styled_names) as f:
        keep = {line.strip() for line in f if line.strip()}
    out_rows = [(n, c) for n, c in rows if n in keep]
    with open(args.out, "w") as f:
        for i, (n, c) in enumerate(out_rows):
            f.write(f"{n}#{i % 5}\t{c}\n")
    names = sorted({n for n, _ in out_rows})
    rng = random.Random(args.seed)
    test = rng.sample(names, min(args.num_test, len(names)))
    with open(args.out + ".test", "w") as f:
        f.write("\n".join(test) + "\n")
    print(f"kept {len(out_rows)} captions / {len(names)} images; "
          f"{len(test)} test images")


def cc_split(args):
    rows = load_cc_captions(args.captions)
    by_dom = {}
    for row in rows:
        by_dom.setdefault(row[2], []).append(row)
    rng = random.Random(args.seed)
    train, val, test = [], [], []
    for dom, items in by_dom.items():
        rng.shuffle(items)
        val.extend(items[: args.val_per_domain])
        test.extend(items[args.val_per_domain : args.val_per_domain + args.test_per_domain])
        train.extend(items[args.val_per_domain + args.test_per_domain :])
    for name, data in (("train", train), ("val", val), ("test", test)):
        with open(f"{args.out_prefix}_{name}.txt", "w") as f:
            for img, cap, dom in data:
                f.write(f"{img}{SEP}{cap}{SEP}{dom}\n")
    print(f"train {len(train)} val {len(val)} test {len(test)} "
          f"across {len(by_dom)} domains")


def merge_all(args):
    out = []
    for row in load_cc_captions(args.cc):
        out.append(SEP.join(row))
    rows = load_factual_captions(args.factual)
    for name, cap in rows:
        out.append(SEP.join((name, cap, "f")))
    for path, dom in ((args.humour, "h"), (args.romantic, "r")):
        if path:
            with open(path) as f:
                for i, line in enumerate(f):
                    out.append(SEP.join((f"flickr_{i}.jpg", line.strip(), dom)))
    rng = random.Random(args.seed)
    rng.shuffle(out)
    with open(args.out, "w") as f:
        f.write("\n".join(out) + "\n")
    print(f"merged {len(out)} captions -> {args.out}")


def analyze_domains(args):
    counts = Counter(dom for _, _, dom in load_cc_captions(args.captions))
    for dom, n in counts.most_common(args.top):
        print(f"{n:6d}  {dom}")
    print(f"total domains: {len(counts)}")


def gcc_select(args):
    """Filter a GCC TSV (caption\\turl) into 5-space caption rows per
    domain, capped per domain (the reference's
    parse_conceptual_captions.py)."""
    per_dom: dict = {}
    idx = 0
    with open(args.tsv) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 2:
                continue
            cap, url = parts[0], parts[1]
            dom = extract_domain(url)
            bucket = per_dom.setdefault(dom, [])
            if len(bucket) < args.per_domain:
                idx += 1
                bucket.append((f"{idx}.jpg", cap, dom, url))
    keep = {d: b for d, b in per_dom.items() if len(b) >= args.min_per_domain}
    with open(args.out, "w") as f, open(args.out + ".urls", "w") as fu:
        for bucket in keep.values():
            for img, cap, dom, url in bucket:
                f.write(f"{img}{SEP}{cap}{SEP}{dom}\n")
                fu.write(f"{img}\t{url}\n")
    print(f"{sum(map(len, keep.values()))} captions across {len(keep)} domains")


def _fetch_one(name: str, url: str, out_dir: str, timeout: float) -> str:
    """Fetch one manifest row -> decode-validate -> RGB JPEG on disk.

    Returns "ok" | "skip" (already downloaded) | "bad".  The reference
    opens the HTTP stream with PIL and saves it as ``<name>``, counting
    unreadable images and connection errors as bad; here the fetch is
    urllib (http, https and file URLs) and the re-encode makes every file
    an RGB JPEG, so the image decoder (``data/native_image.py``) always
    sees a baseline JPEG.
    """
    import io
    import os
    import urllib.request

    dst = os.path.join(out_dir, name)
    if os.path.exists(dst):
        return "skip"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            raw = r.read()
        from PIL import Image

        img = Image.open(io.BytesIO(raw))
        img.convert("RGB").save(dst, format="JPEG", quality=95)
        return "ok"
    except Exception:
        try:
            if os.path.exists(dst):
                os.remove(dst)  # never leave a truncated file behind
        except OSError:
            pass
        return "bad"


def gcc_download(args):
    """Fetch a ``gcc-select`` ``.urls`` manifest into an image tree.

    Selection (text only, ``gcc-select``) and the download (this command)
    are separate steps, so the fetch is threaded, resumable (existing
    files are skipped) and can be run again after partial failures.  With
    ``--captions`` the caption file is filtered to the rows whose image
    downloaded, and a domain whose failures pass ``--max-bad-per-domain``
    with no success is dropped whole (the reference's ``is_bad_domain``
    rule).
    """
    import concurrent.futures as cf
    import os

    rows = []
    with open(args.manifest) as f:
        for line in f:
            line = line.rstrip("\n")
            if line:
                name, url = line.split("\t", 1)
                rows.append((name, url))
    os.makedirs(args.out_dir, exist_ok=True)

    status: dict = {}
    with cf.ThreadPoolExecutor(max_workers=args.workers) as ex:
        futs = {
            ex.submit(_fetch_one, n, u, args.out_dir, args.timeout): n
            for n, u in rows
        }
        for fut in cf.as_completed(futs):
            status[futs[fut]] = fut.result()

    ok = sum(1 for s in status.values() if s != "bad")
    skipped = sum(1 for s in status.values() if s == "skip")
    print(f"downloaded {ok - skipped} / {len(rows)} "
          f"({skipped} already present, {len(rows) - ok} bad)")

    if args.captions:
        kept, bad_by_dom, ok_by_dom = [], Counter(), Counter()
        cap_rows = load_cc_captions(args.captions)
        for img, cap, dom in cap_rows:
            if status.get(img, "bad") == "bad":
                bad_by_dom[dom] += 1
            else:
                ok_by_dom[dom] += 1
        bad_doms = {d for d, n in bad_by_dom.items()
                    if n > args.max_bad_per_domain and ok_by_dom[d] == 0}
        for img, cap, dom in cap_rows:
            if status.get(img) in ("ok", "skip") and dom not in bad_doms:
                kept.append((img, cap, dom))
        out = args.filtered_out or args.captions + ".downloaded"
        with open(out, "w") as f:
            for row in kept:
                f.write(SEP.join(row) + "\n")
        print(f"kept {len(kept)} / {len(cap_rows)} caption rows -> {out}"
              + (f" (dropped bad domains: {sorted(bad_doms)})"
                 if bad_doms else ""))


def shuffle(args):
    with open(args.infile) as f:
        lines = f.readlines()
    random.Random(args.seed).shuffle(lines)
    with open(args.out, "w") as f:
        f.writelines(lines)
    print(f"shuffled {len(lines)} lines")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("flickr-select")
    s.add_argument("--factual", required=True)
    s.add_argument("--styled-names", required=True)
    s.add_argument("--out", required=True)
    s.add_argument("--num-test", type=int, default=100)
    s.add_argument("--seed", type=int, default=0)
    s.set_defaults(fn=flickr_select)

    s = sub.add_parser("cc-split")
    s.add_argument("--captions", required=True)
    s.add_argument("--out-prefix", required=True)
    s.add_argument("--val-per-domain", type=int, default=2)
    s.add_argument("--test-per-domain", type=int, default=2)
    s.add_argument("--seed", type=int, default=0)
    s.set_defaults(fn=cc_split)

    s = sub.add_parser("merge-all")
    s.add_argument("--cc", required=True)
    s.add_argument("--factual", required=True)
    s.add_argument("--humour", default="")
    s.add_argument("--romantic", default="")
    s.add_argument("--out", required=True)
    s.add_argument("--seed", type=int, default=0)
    s.set_defaults(fn=merge_all)

    s = sub.add_parser("analyze-domains")
    s.add_argument("--captions", required=True)
    s.add_argument("--top", type=int, default=30)
    s.set_defaults(fn=analyze_domains)

    s = sub.add_parser("gcc-select")
    s.add_argument("--tsv", required=True)
    s.add_argument("--out", required=True)
    s.add_argument("--per-domain", type=int, default=200)
    s.add_argument("--min-per-domain", type=int, default=50)
    s.set_defaults(fn=gcc_select)

    s = sub.add_parser("gcc-download")
    s.add_argument("--manifest", required=True,
                   help="the .urls file emitted by gcc-select")
    s.add_argument("--out-dir", required=True)
    s.add_argument("--captions", default="",
                   help="gcc-select caption file to filter by download success")
    s.add_argument("--filtered-out", default="",
                   help="path for the filtered captions "
                        "(default: <captions>.downloaded)")
    s.add_argument("--workers", type=int, default=16)
    s.add_argument("--timeout", type=float, default=10.0)
    s.add_argument("--max-bad-per-domain", type=int, default=50)
    s.set_defaults(fn=gcc_download)

    s = sub.add_parser("shuffle")
    s.add_argument("--infile", required=True)
    s.add_argument("--out", required=True)
    s.add_argument("--seed", type=int, default=0)
    s.set_defaults(fn=shuffle)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
