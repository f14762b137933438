"""hloc (hierarchical-localization) SfM runner: the reference's default
``sfm_tool`` (its base.yaml sets ``sfm_tool: hloc``; ``ns-process-data``
dispatches to hloc's SuperPoint+SuperGlue pipeline).

Counterpart of the JAX package's ``pipeline/hloc.py``, an own copy.  Like
the COLMAP runner (``pipeline/colmap.py``) this is an external-tool
contract: when the ``hloc`` package is importable its standard recipe runs
(retrieval -> local features -> matching -> pycolmap reconstruction) and
the result is converted to transforms.json; when it is not,
:func:`run_hloc_sfm` raises a clear error and ``Splatter`` falls back to
COLMAP if that is on PATH (``splatter.py::_run_sfm``).
"""


from __future__ import annotations

from pathlib import Path
from typing import Optional


class HlocError(RuntimeError):
    pass


def hloc_available() -> bool:
    try:
        import hloc  # noqa: F401
        import pycolmap  # noqa: F401

        return True
    except Exception:
        return False


def run_hloc_sfm(
    images_dir: Path,
    out_dir: Path,
    matcher: str = "exhaustive",
    num_matched: int = 50,
) -> Path:
    """SuperPoint + SuperGlue SfM via hloc; writes transforms.json.

    Args:
        images_dir: directory of input frames.
        out_dir: dataset root; transforms.json + hloc/ land here.
        matcher: "exhaustive" (all pairs, small sets) or "sequential"
            (NetVLad retrieval pairs, video frames).
        num_matched: retrieval fan-out for the non-exhaustive path.
    """
    if not hloc_available():
        raise HlocError(
            "hloc (and pycolmap) are not installed: the hloc sfm_tool "
            "needs `pip install hloc pycolmap` plus its model downloads. "
            "Use sfm_tool='colmap' for the fully-offline path."
        )
    from hloc import (
        extract_features,
        match_features,
        pairs_from_exhaustive,
        pairs_from_retrieval,
        reconstruction,
    )

    images_dir = Path(images_dir)
    out_dir = Path(out_dir)
    work = out_dir / "hloc"
    work.mkdir(parents=True, exist_ok=True)
    sfm_pairs = work / "pairs.txt"
    sfm_dir = work / "sfm"

    feature_conf = extract_features.confs["superpoint_aachen"]
    matcher_conf = match_features.confs["superglue"]
    features = extract_features.main(feature_conf, images_dir, work)
    if matcher == "exhaustive":
        image_list = sorted(
            p.name for p in images_dir.iterdir()
            if p.suffix.lower() in (".jpg", ".jpeg", ".png")
        )
        pairs_from_exhaustive.main(sfm_pairs, image_list=image_list)
    else:
        retrieval_conf = extract_features.confs["netvlad"]
        retrieval = extract_features.main(retrieval_conf, images_dir, work)
        pairs_from_retrieval.main(
            retrieval, sfm_pairs, num_matched=num_matched
        )
    matches = match_features.main(
        matcher_conf, sfm_pairs, feature_conf["output"], work
    )
    model = reconstruction.main(
        sfm_dir, images_dir, sfm_pairs, features, matches
    )
    if model is None or model.num_reg_images() == 0:
        raise HlocError("hloc reconstruction registered no images")
    return _model_to_transforms(model, images_dir, out_dir)


def _model_to_transforms(model, images_dir: Path, out_dir: Path) -> Path:
    """pycolmap.Reconstruction -> transforms.json (+ sparse ply).

    The model is dumped to COLMAP TXT and fed through the COLMAP runner's
    converter (colmap.py::write_dataset_outputs) so both SfM tools emit
    byte-identical dataset metadata."""
    from .colmap import write_dataset_outputs

    txt = out_dir / "hloc" / "txt"
    txt.mkdir(parents=True, exist_ok=True)
    model.write_text(str(txt))
    return write_dataset_outputs(txt, images_dir, out_dir)
