"""A copy of ``multimodal_baby_tpu/data/etl.py`` (tests hold the outputs
of the two byte for byte equal on the same raw tree), kept so that the port
imports nothing of the JAX package. One change: ``filter_eval_frames``'
default scorer, the CLIP ViT-B/16 baseline (``openai/clip-vit-base-patch16``),
is the port's (``evaluation/clip_baseline.py``), on the card unless
``device`` says otherwise; it reads the weights from a local directory or
the Hugging Face cache and refuses where neither holds them, as the port
never downloads.

Offline ETL: SAYCam transcripts + videos -> training-ready metadata.

Reproduces the reference's idempotent, resumable prepare_data pipeline
(multimodal_saycam_data_module.py:159-1263; every step skips if its output
exists):

  1. transcript preprocessing: timestamp parsing, utterance cleaning +
     sentence splitting, per-utterance frame timestamps (<=32 @ 5 fps)
  2. frame extraction from videos (OpenCV seek; resize-256 / center-crop
     224 with the reference's -16px vertical offset / horizontal flip —
     SAYCam cameras are mounted upside-down)
  3. train/val/test metadata JSONs + shuffled-utterance ablation file
  4. eval-trial generation (n trials/category, n_foils)
  5. vocabulary (freq >= 3, frequency-ordered ids)

The output JSON/vocab schema is byte-compatible with the reference, so
datasets prepared by either codebase interchange.
"""

from __future__ import annotations

import json
import random
import re
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from multimodal_baby_tpu_torch.core.constants import (
    IMAGE_H, IMAGE_W, UNK_TOKEN)
from multimodal_baby_tpu_torch.data.vocab import Vocab

MAX_FRAMES_PER_UTTERANCE = 32
FRAMES_PER_SECOND = 5
TRAIN_FRAC, VAL_FRAC = 0.9, 0.05
DEFAULT_ALLOWED_SPEAKERS = ("M", "Mom", "mom", "m", "mother", "Mother",
                            "papa", "the mom")
# categories dropped from eval because they're absent from the vocab
# (multimodal_saycam_data_module.py:876-880)
EXCLUDED_EVAL_CATEGORIES = ("carseat", "couch", "greenery", "plushanimal")


# ---------------------------------------------------------------------------
# 1. transcript preprocessing
# ---------------------------------------------------------------------------

def _msplit(s: str, seps) -> List[str]:
    out = [s]
    for sep in seps:
        out = [piece for part in out for piece in part.split(sep)]
    return out


def convert_timestamp_to_seconds(timestamp) -> Optional[int]:
    """Parse one messy SAYCam transcript timestamp ("MM:SS", "MM.SS",
    "MM:SS-MM:SS" ranges, bare minutes, single-digit tens-of-seconds) into
    seconds (reference: multimodal/utils.py:25-75)."""
    timestamp = str(timestamp)
    if timestamp == "nan":
        return None
    first = _msplit(timestamp, "-")[0]
    if first == "":
        return None
    splits = _msplit(first, (":", ".", ",", ";"))
    if splits[0] == "":
        splits[0] = "0"
    if len(splits) == 1:
        splits.append("0")
    elif splits[1] in ("1", "2", "3", "4", "5"):
        splits[1] = splits[1] + "0"  # single-digit tens of seconds
    s0, s1 = splits[0].strip(), splits[1].strip()
    if len(s1) > 2:
        return None  # float-like timestamps: meaning unknown, dropped
    try:
        return int(s0) * 60 + int(s1)
    except ValueError:
        return None


_INAUDIBLE = "INAUDIBLE"
_BRACKETED = (r"\*[^)]*\*", r"\[[^)]*\]", r"\([^)]*\)", r"\binaudible\b")


def clean_utterance(utterance: str) -> str:
    """Strip bracketed asides, mapping any 'inaudible' marker to a
    placeholder that later becomes <unk>
    (reference: multimodal_saycam_data_module.py:399-406)."""
    def repl(m):
        return _INAUDIBLE if "inaudible" in m.group(0) else ""

    for pat in _BRACKETED:
        utterance = re.sub(pat, repl, utterance)
    return utterance.replace("*", "")


def _split_sentences(text: str) -> List[List[str]]:
    """Sentence-split + tokenize. spaCy when available; a punctuation-based
    fallback otherwise."""
    from multimodal_baby_tpu_torch.data.tokenizer import (
        _get_spacy, word_tokenize)
    nlp = _get_spacy()
    if nlp is not None:
        return [[t.text for t in sent] for sent in nlp(text).sents]
    sents = re.split(r"(?<=[.!?])\s+", text.strip())
    return [word_tokenize(s) for s in sents if s.strip()]


def preprocess_utterance(
    utterance: str, start_timestamp: float, end_timestamp: float,
) -> Tuple[List[str], List[np.ndarray], List[int]]:
    """One raw utterance -> (clean sub-utterances, per-sub frame timestamps,
    frame counts); interpolated timestamps, <=32 frames @ 5 fps each
    (reference: multimodal_saycam_data_module.py:393-445)."""
    assert start_timestamp <= end_timestamp
    utterance = clean_utterance(utterance)
    utterances = [
        " ".join(UNK_TOKEN if tok == _INAUDIBLE else tok.lower()
                 for tok in sent)
        for sent in _split_sentences(utterance)]
    utterances = [u for u in utterances if u]

    all_timestamps: List[np.ndarray] = []
    num_frames: List[int] = []
    if utterances:
        bounds = np.linspace(start_timestamp, end_timestamp,
                             len(utterances) + 1, endpoint=True)
        bounds = [int(b) for b in bounds]
        for i in range(len(bounds) - 1):
            n = max(min(int((bounds[i + 1] - bounds[i])
                            / (1 / FRAMES_PER_SECOND)),
                        MAX_FRAMES_PER_UTTERANCE), 1)
            ts = np.linspace(bounds[i], bounds[i] + n / FRAMES_PER_SECOND,
                             n, endpoint=False)
            all_timestamps.append(ts)
            num_frames.append(n)
    return utterances, all_timestamps, num_frames


def preprocess_transcript(
    transcript_csv,
    allowed_speakers: Sequence[str] = DEFAULT_ALLOWED_SPEAKERS,
) -> List[dict]:
    """One raw transcript CSV (columns: Time, Speaker, Utterance,
    Video Name) -> rows of
    {transcript_filename, video_filename, utterance, timestamp,
     utterance_num, frame_num, frame_filename}
    (reference: multimodal_saycam_data_module.py:256-445)."""
    import pandas as pd

    transcript_csv = Path(transcript_csv)
    df = pd.read_csv(transcript_csv)
    if len(df) <= 1:
        return []

    seconds = [convert_timestamp_to_seconds(t) for t in df["Time"]]

    video_names = [v for v in pd.unique(df["Video Name"])
                   if not pd.isnull(v) and "part" not in str(v)]
    if len(video_names) != 1:
        return []
    video_filename = Path(str(video_names[0])).with_suffix(".mp4")

    rows: List[dict] = []
    utterance_num = 1
    for i, row in df.iterrows():
        start = seconds[i]
        end = seconds[i + 1] if i < len(df) - 1 else start
        if start is None or end is None or \
                str(row["Speaker"]) not in allowed_speakers:
            continue
        if end < start:
            continue
        utts, stamps, counts = preprocess_utterance(
            str(row["Utterance"]), start, end)
        for utt, ts, n in zip(utts, stamps, counts):
            for frame_num, t in enumerate(ts):
                rows.append({
                    "transcript_filename": transcript_csv.name,
                    "video_filename": video_filename.name,
                    "utterance": utt,
                    "timestamp": float(t),
                    "utterance_num": utterance_num,
                    "frame_num": frame_num,
                    "frame_filename": (
                        f"{video_filename.stem}_{utterance_num:03}"
                        f"_{frame_num:02}.jpg"),
                })
            utterance_num += 1
    return rows


# ---------------------------------------------------------------------------
# 2. frame extraction
# ---------------------------------------------------------------------------

def extract_frame_array(frame: np.ndarray) -> Optional[np.ndarray]:
    """Resize minor side to 256, center-crop 224 with the reference's -16px
    vertical offset, flip both axes (the SAYCam head camera is mounted
    upside down) — multimodal_saycam_data_module.py:511-542. BGR->kept
    as-is; callers pass RGB or save via cv2 (BGR)."""
    import cv2 as cv

    if frame is None:
        return None
    h, w = frame.shape[:2]
    minor = 256
    nh = h * minor // min(h, w)
    nw = w * minor // min(h, w)
    try:
        resized = cv.resize(frame, (nw, nh), interpolation=cv.INTER_CUBIC)
    except Exception:
        return None
    startx = nw // 2 - IMAGE_W // 2
    starty = nh // 2 - IMAGE_H // 2 - 16
    cropped = resized[starty:starty + IMAGE_H, startx:startx + IMAGE_W]
    if cropped.shape[0] != IMAGE_H or cropped.shape[1] != IMAGE_W:
        return None
    return cropped[::-1, ::-1]  # 180-degree rotation


def extract_frames(preprocessed_dir, video_dir, frames_dir) -> int:
    """Extract every frame referenced by the preprocessed transcripts.
    Returns the number of frames written. Idempotent (skips existing)."""
    import cv2 as cv
    import pandas as pd

    frames_dir = Path(frames_dir)
    frames_dir.mkdir(parents=True, exist_ok=True)
    n_written = 0
    for csv_path in sorted(Path(preprocessed_dir).glob("*.csv")):
        df = pd.read_csv(csv_path)
        video = Path(video_dir) / str(pd.unique(df["video_filename"])[0])
        if not video.exists():
            continue
        cap = cv.VideoCapture(str(video))
        fps = cap.get(cv.CAP_PROP_FPS) or FRAMES_PER_SECOND
        for _, row in df.iterrows():
            out = frames_dir / str(row["frame_filename"])
            if out.exists():
                continue
            cap.set(cv.CAP_PROP_POS_FRAMES,
                    int(float(row["timestamp"]) * fps))
            ok, frame = cap.read()
            if not ok:
                continue
            frame = extract_frame_array(frame)
            if frame is not None:
                cv.imwrite(str(out), frame)
                n_written += 1
        cap.release()
    return n_written


# ---------------------------------------------------------------------------
# 3-5. metadata, eval trials, vocab
# ---------------------------------------------------------------------------

def create_train_metadata(
    preprocessed_dir, frames_dir, out_dir,
    train_frac: float = TRAIN_FRAC, val_frac: float = VAL_FRAC,
    seed: int = 0, require_frames: bool = True,
) -> Dict[str, int]:
    """Group preprocessed rows by utterance, attach existing frame
    filenames, shuffle, split train/val/test, write JSONs
    (reference: multimodal_saycam_data_module.py:737-836)."""
    import pandas as pd

    out_dir = Path(out_dir)
    frames_dir = Path(frames_dir)
    utterances: List[dict] = []
    for csv_path in sorted(Path(preprocessed_dir).glob("*.csv")):
        df = pd.read_csv(csv_path)
        for _, group in df.groupby("utterance_num"):
            utt = str(group["utterance"].iloc[0])
            if utt == "nan":
                continue
            frame_filenames = []
            for name in sorted(group["frame_filename"]):
                path = frames_dir / str(name)
                if not require_frames or path.exists():
                    frame_filenames.append(str(path))
            if not frame_filenames:
                continue
            utterances.append({
                "utterance": utt,
                "transcript_filename": str(
                    group["transcript_filename"].iloc[0]),
                "video_filename": str(group["video_filename"].iloc[0]),
                "utterance_num": int(group["utterance_num"].iloc[0]),
                "num_frames": len(group),
                "timestamps": [float(t) for t in group["timestamp"]],
                "frame_filenames": frame_filenames,
            })

    random.Random(seed).shuffle(utterances)
    n = len(utterances)
    train_n = int(n * train_frac)
    val_n = int(n * val_frac)
    splits = {
        "train": utterances[:train_n],
        "val": utterances[train_n:train_n + val_n],
        "test": utterances[train_n + val_n:],
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    for split, data in splits.items():
        with open(out_dir / f"{split}.json", "w") as f:
            json.dump({"data": data}, f)
    return {k: len(v) for k, v in splits.items()}


def create_shuffled_metadata(out_dir, seed: int = 0) -> None:
    """Shuffled-utterance ablation: break image-text pairing
    (reference: multimodal_saycam_data_module.py:836-857)."""
    out_dir = Path(out_dir)
    with open(out_dir / "train.json") as f:
        data = json.load(f)["data"]
    utts = [d["utterance"] for d in data]
    random.Random(seed).shuffle(utts)
    for d, u in zip(data, utts):
        d["utterance"] = u
    with open(out_dir / "train_shuffled.json", "w") as f:
        json.dump({"data": data}, f)


def create_eval_metadata(
    eval_frames_dir, out_dir,
    n_foils: int = 3, n_evaluations: int = 100,
    excluded_categories: Sequence[str] = EXCLUDED_EVAL_CATEGORIES,
    seed: int = 0, prefix: str = "eval",
) -> List[str]:
    """Per-category forced-choice trials from dev/test frame directories
    (reference: multimodal_saycam_data_module.py:859-954). Also supports
    the n_foils in {3, 9, 21} 'extra' variants via the n_foils arg."""
    rng = np.random.RandomState(seed)
    eval_frames_dir = Path(eval_frames_dir)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    categories = None
    for stage in ("dev", "test"):
        stage_dir = eval_frames_dir / stage
        cats = sorted(d.name for d in stage_dir.iterdir() if d.is_dir())
        # empty dirs can occur after CLIP filtering: no trials for them
        cats = [c for c in cats if c not in excluded_categories
                and any((stage_dir / c).iterdir())]
        categories = cats
        trials = []
        for target in cats:
            target_frames = sorted(
                str(p) for p in (stage_dir / target).iterdir())
            for i in range(n_evaluations):
                foils = list(rng.choice(
                    [c for c in cats if c != target], size=n_foils,
                    replace=False))
                trials.append({
                    "trial_num": i,
                    "target_category": target,
                    "target_img_filename": str(
                        target_frames[rng.randint(len(target_frames))]),
                    "foil_categories": foils,
                    "foil_img_filenames": [
                        str((lambda fr: fr[rng.randint(len(fr))])(
                            sorted(str(p)
                                   for p in (stage_dir / c).iterdir())))
                        for c in foils],
                })
        suffix = "" if n_foils == 3 else f"_{n_foils + 1}"
        with open(out_dir / f"{prefix}{suffix}_{stage}.json", "w") as f:
            json.dump({"data": trials}, f)
    return categories


def create_vocab(out_dir, freq_threshold: int = 3) -> Vocab:
    """Vocabulary from the train split (reference:
    multimodal_saycam_data_module.py:1219-1263)."""
    out_dir = Path(out_dir)
    with open(out_dir / "train.json") as f:
        data = json.load(f)["data"]
    vocab = Vocab.build((d["utterance"] for d in data),
                        min_freq=freq_threshold)
    vocab.save(out_dir / "vocab.json")
    return vocab


def animate_utterance(entry: dict, out_path, duration_ms: int = 200,
                      frames_dir=None) -> Optional[Path]:
    """Debug tool: animated GIF of an utterance's frames
    (reference: multimodal_saycam_data_module.py:1266-1313)."""
    from PIL import Image, ImageDraw

    frames = []
    for name in entry["frame_filenames"]:
        path = Path(frames_dir) / name if frames_dir else Path(name)
        if not path.exists():
            continue
        img = Image.open(path).convert("RGB")
        draw = ImageDraw.Draw(img)
        draw.text((4, img.height - 14), entry["utterance"][:60],
                  fill=(255, 255, 0))
        frames.append(img)
    if not frames:
        return None
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    frames[0].save(out_path, save_all=True, append_images=frames[1:],
                   duration=duration_ms, loop=0)
    return out_path


# ---------------------------------------------------------------------------
# 0. transcript download
# ---------------------------------------------------------------------------

def _sheet_export_urls(link: str) -> str:
    """Google-Sheets share link -> public CSV export URL."""
    m = re.search(r"/spreadsheets/d/([A-Za-z0-9_-]+)", link)
    if not m:
        raise ValueError(f"not a Google Sheets link: {link}")
    return (f"https://docs.google.com/spreadsheets/d/{m.group(1)}"
            f"/export?format=csv")


def download_transcripts(links_csv, out_dir, fetch=None,
                         sleep_s: float = 30.0) -> int:
    """Download SAYCam transcripts listed in a links CSV
    (reference: multimodal_saycam_data_module.py:214-253).

    Differences from the reference, by design: the reference drives the
    authenticated gsheets API (credentials file + per-worksheet
    enumeration); this uses the public CSV export URL per sheet, with the
    fetch callable injectable (``fetch(url) -> bytes``) so the step is
    testable offline. Idempotent: skips when ``out_dir`` exists. Returns
    the number of files written.
    """
    import pandas as pd

    out_dir = Path(out_dir)
    if out_dir.exists():
        print("transcripts already downloaded; skipping")
        return 0
    if fetch is None:
        from urllib.request import urlopen

        def fetch(url):  # pragma: no cover - needs network
            with urlopen(url, timeout=60) as r:
                return r.read()

    df = pd.read_csv(links_csv)
    links = df["GoogleSheets Link"].dropna().unique()
    out_dir.mkdir(parents=True)
    written = 0
    for i, link in enumerate(links):
        url = _sheet_export_urls(link)
        print(f"downloading transcript {i + 1}/{len(links)}")
        try:
            payload = fetch(url)
        except Exception as e:  # rate limits / private sheets
            print(f"  fetch failed ({e}); skipping")
            continue
        title = None
        if "Title" in df.columns:
            row = df[df["GoogleSheets Link"] == link]
            if len(row):
                title = str(row.iloc[0]["Title"])
        name = title or f"transcript_{i:03d}"
        (out_dir / f"{name}.csv").write_bytes(
            payload if isinstance(payload, bytes) else payload.encode())
        written += 1
        if sleep_s and i + 1 < len(links):
            import time
            time.sleep(sleep_s)  # reference rate-limit guard
    return written


# ---------------------------------------------------------------------------
# 5. eval-frame filtering + dev/test splits
# ---------------------------------------------------------------------------

def filter_eval_frames(labeled_s_dir, filtered_dir, scorer=None,
                       excluded_categories: Sequence[str] =
                       EXCLUDED_EVAL_CATEGORIES,
                       batch_size: int = 64, device="cuda") -> int:
    """CLIP self-filtering of the Labeled-S eval frames (reference:
    multimodal_saycam_data_module.py:545-606): keep a frame only if a
    zero-shot classifier's top category over all eval categories matches
    the frame's own category.

    ``scorer(images_u8 [N,H,W,3], categories) -> pred indices [N]``; the
    default builds the CLIP ViT-B/16 baseline (evaluation.clip_baseline, on
    ``device``; needs the weights locally). Idempotent: skips when
    ``filtered_dir`` exists. Returns number of frames kept.
    """
    import shutil

    from PIL import Image

    labeled_s_dir = Path(labeled_s_dir)
    filtered_dir = Path(filtered_dir)
    if filtered_dir.exists():
        print("eval frames already filtered; skipping")
        return 0

    categories = sorted(d.name for d in labeled_s_dir.iterdir()
                        if d.is_dir())
    categories = [c for c in categories if c not in excluded_categories]

    if scorer is None:
        from multimodal_baby_tpu_torch.evaluation.clip_baseline import (
            CLIPBaseline)
        clip = CLIPBaseline(model_name="openai/clip-vit-base-patch16",
                            device=device)
        text_features = clip.encode_text(categories)

        def scorer(images_u8, cats):
            img_features = clip.encode_image(images_u8)
            return (img_features @ text_features.T).argmax(-1)

    filtered_dir.mkdir(parents=True)
    kept = 0
    for ci, category in enumerate(categories):
        (filtered_dir / category).mkdir()
        frames = sorted((labeled_s_dir / category).glob("*.jpeg")) + \
            sorted((labeled_s_dir / category).glob("*.jpg")) + \
            sorted((labeled_s_dir / category).glob("*.png"))
        for s in range(0, len(frames), batch_size):
            chunk = frames[s:s + batch_size]
            imgs = np.stack([
                np.asarray(Image.open(p).convert("RGB")) for p in chunk])
            preds = np.asarray(scorer(imgs, categories))
            for p, pred in zip(chunk, preds):
                if int(pred) == ci:
                    shutil.copyfile(p, filtered_dir / category / p.name)
                    kept += 1
    return kept


def split_eval_frames(labeled_s_dir, out_dir, seed: int = 0) -> None:
    """50/50 per-category dev/test split of (possibly filtered) Labeled-S
    frames (reference: multimodal_saycam_data_module.py:608-734).
    Idempotent: skips when ``out_dir`` exists."""
    import shutil

    labeled_s_dir = Path(labeled_s_dir)
    out_dir = Path(out_dir)
    if out_dir.exists():
        print("eval frames already split; skipping")
        return
    rng = np.random.RandomState(seed)
    for category_dir in sorted(labeled_s_dir.iterdir()):
        if not category_dir.is_dir():
            continue
        frames = sorted(p.name for p in category_dir.iterdir())
        idxs = np.arange(len(frames))
        rng.shuffle(idxs)
        half = int(len(frames) * 0.5)
        for stage, stage_idxs in (("dev", idxs[:half]),
                                  ("test", idxs[half:])):
            dst = out_dir / stage / category_dir.name
            dst.mkdir(parents=True, exist_ok=True)
            for i in stage_idxs:
                shutil.copyfile(category_dir / frames[i], dst / frames[i])


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------

def prepare_data(
    data_dir,
    transcript_dir=None,
    video_dir=None,
    eval_frames_dir=None,
    allowed_speakers: Sequence[str] = DEFAULT_ALLOWED_SPEAKERS,
    seed: int = 0,
    transcript_links_csv=None,
    labeled_s_dir=None,
    clip_scorer=None,
    fetch=None,
) -> None:
    """Idempotent end-to-end ETL (reference prepare_data:
    multimodal_saycam_data_module.py:159-176). Steps whose inputs are
    absent are skipped, so partially-materialized datasets resume.

    Full from-raw staging: ``transcript_links_csv`` downloads transcripts
    into ``data_dir/transcripts`` (becoming ``transcript_dir``);
    ``labeled_s_dir`` splits the Labeled-S frames 50/50 into
    ``data_dir/eval`` and, when a CLIP scorer is available (``clip_scorer``
    or local CLIP weights), also builds the CLIP-filtered variant under
    ``data_dir/eval_filtered`` + ``eval_filtered_{dev,test}.json``.
    """
    import pandas as pd

    data_dir = Path(data_dir)
    pre_dir = data_dir / "preprocessed_transcripts_5fps"
    frames_dir = data_dir / "train_5fps"

    if transcript_links_csv and Path(transcript_links_csv).exists() \
            and transcript_dir is None:
        transcript_dir = data_dir / "transcripts"
        download_transcripts(transcript_links_csv, transcript_dir,
                             fetch=fetch)

    if labeled_s_dir and Path(labeled_s_dir).exists():
        if eval_frames_dir is None:
            eval_frames_dir = data_dir / "eval"
            split_eval_frames(labeled_s_dir, eval_frames_dir, seed=seed)
        # CLIP-filtered variant (skip-if-unavailable: needs a scorer or
        # local CLIP weights)
        filtered_src = data_dir / "labeled_s_filtered"
        filtered_eval = data_dir / "eval_filtered"
        try:
            filter_eval_frames(labeled_s_dir, filtered_src,
                               scorer=clip_scorer)
        except Exception as e:
            print(f"CLIP eval-frame filtering unavailable ({e}); skipping")
        if filtered_src.exists() and not filtered_eval.exists():
            split_eval_frames(filtered_src, filtered_eval, seed=seed)
        if filtered_eval.exists() \
                and not (data_dir / "eval_filtered_dev.json").exists():
            create_eval_metadata(filtered_eval, data_dir, seed=seed,
                                 prefix="eval_filtered")

    if transcript_dir and Path(transcript_dir).exists() \
            and not pre_dir.exists():
        pre_dir.mkdir(parents=True)
        for csv_path in sorted(Path(transcript_dir).glob("*.csv")):
            rows = preprocess_transcript(csv_path, allowed_speakers)
            if rows:
                pd.DataFrame(rows).to_csv(pre_dir / csv_path.name,
                                          index=False)

    if video_dir and Path(video_dir).exists() and pre_dir.exists():
        extract_frames(pre_dir, video_dir, frames_dir)

    if pre_dir.exists() and not (data_dir / "train.json").exists():
        create_train_metadata(pre_dir, frames_dir, data_dir, seed=seed,
                              require_frames=frames_dir.exists())
        create_shuffled_metadata(data_dir, seed=seed)

    if eval_frames_dir and Path(eval_frames_dir).exists() \
            and not (data_dir / "eval_dev.json").exists():
        create_eval_metadata(eval_frames_dir, data_dir, seed=seed)

    if (data_dir / "train.json").exists() \
            and not (data_dir / "vocab.json").exists():
        create_vocab(data_dir)
