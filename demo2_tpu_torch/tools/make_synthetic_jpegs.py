"""Write an RGBNT201-layout synthetic JPEG dataset to disk (the JAX
package's tools/make_synthetic_jpegs.py).

    python3 -m demo2_tpu_torch.tools.make_synthetic_jpegs --root DIR [--writer pil|native]

Produces root/RGBNT201/{train_171,test}/{RGB,NI,TI}/<pid>_cam<k>_<j>.jpg, by
default at RGBNT201's scale (171 train ids x 23 images, 30 test ids x 14),
the images rendered by SyntheticTriModal's hard recipe (identity in a small
palette offset under heavy noise) at a source size larger than the train
size, so that the loader's resize does real work.  The JPEGs are written by
PIL (`writer="pil"`, the JAX package's writer: 4:2:0 chroma, so the same
tree byte for byte) or by the port's native writer (`writer="native"`,
data/native.py::write_jpeg: libjpeg or nvJPEG, 4:4:4, no PIL needed).
"""

from __future__ import annotations

import argparse
import glob
import os
import os.path as osp
import shutil
import time

WRITERS = ("pil", "native")


def _writer(writer: str):
    """save(path, (H, W, 3) uint8 array, quality) of the chosen writer."""
    if writer == "pil":
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError(f"PIL does not import ({e}); writer='native' writes the JPEGs "
                              "without it") from e
        return lambda path, img, quality: Image.fromarray(img).save(path, quality=quality)
    if writer == "native":
        from ..data.native import write_jpeg

        return lambda path, img, quality: write_jpeg(path, img, quality=quality)
    raise ValueError(f"writer must be one of {WRITERS}, got {writer!r}")


def generate(root: str, num_pids: int = 171, imgs_per_pid: int = 23, test_pids: int = 30,
             test_imgs_per_pid: int = 14, num_cams: int = 6, src_size=(288, 144), seed: int = 0,
             quality: int = 95, id_weight: float = 0.35, writer: str = "pil") -> str:
    """Write the tree under `root` and return `root`.  `id_weight` scales
    the hard recipe's identity signal (lower is harder to separate).

    The marker rule: a marker file names every render parameter (the
    writer too, where it is not PIL), and the tree is kept only when that
    marker is the only one there; otherwise the whole tree is removed and
    written again.  All parameterizations share one tree and its file names,
    so a marker that outlived a change of parameters would let a run train
    on another run's images."""
    from ..data.datasets import SyntheticTriModal

    save = _writer(writer)
    h, w = src_size
    base = osp.join(root, "RGBNT201")
    idw = "" if id_weight == 0.35 else f"_w{id_weight:g}"
    tag = "" if writer == "pil" else f"_{writer}"
    marker = osp.join(base, f".complete_{num_pids}x{imgs_per_pid}_{test_pids}x"
                            f"{test_imgs_per_pid}_{h}x{w}_c{num_cams}_q{quality}_s{seed}{idw}{tag}")
    if glob.glob(osp.join(base, ".complete_*")) == [marker]:
        return root
    if osp.exists(base):
        shutil.rmtree(base)
    renderer = SyntheticTriModal(num_pids=max(num_pids, test_pids), num_cams=num_cams,
                                 imgs_per_pid=1, image_size=(h, w), seed=seed, hard=True,
                                 id_weight=id_weight)
    mods = ("RGB", "NI", "TI")

    def write_split(split_dir: str, pids, per_pid: int, split: str) -> None:
        for m in mods:
            os.makedirs(osp.join(split_dir, m), exist_ok=True)
        for pid in pids:
            for j in range(per_pid):
                imgs = renderer.render((split, pid, j))
                name = f"{pid:06d}_cam{(pid + j) % num_cams + 1}_{j:03d}.jpg"
                for m, img in zip(mods, imgs):
                    save(osp.join(split_dir, m, name), img, quality)

    write_split(osp.join(base, "train_171"), range(num_pids), imgs_per_pid, "train")
    # Test ids are disjoint from the train ids in label only (the parser relabels train).
    write_split(osp.join(base, "test"), range(test_pids), test_imgs_per_pid, "test")
    with open(marker, "w") as f:
        f.write("ok\n")
    return root


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--pids", type=int, default=171)
    ap.add_argument("--imgs_per_pid", type=int, default=23)
    ap.add_argument("--test_pids", type=int, default=30)
    ap.add_argument("--test_imgs_per_pid", type=int, default=14)
    ap.add_argument("--src_h", type=int, default=288)
    ap.add_argument("--src_w", type=int, default=144)
    ap.add_argument("--writer", default="pil", choices=WRITERS)
    args = ap.parse_args(argv)
    t0 = time.time()
    generate(args.root, args.pids, args.imgs_per_pid, args.test_pids, args.test_imgs_per_pid,
             src_size=(args.src_h, args.src_w), writer=args.writer)
    n = args.pids * args.imgs_per_pid + args.test_pids * args.test_imgs_per_pid
    print(f"wrote {n} tri-modal samples ({3 * n} JPEGs) under {args.root} in "
          f"{time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
