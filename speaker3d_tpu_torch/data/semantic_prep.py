"""Semantic-speaker data preparation: TextGrid -> trans7time -> task JSONL.

The port's copy of ``speaker3d_tpu/data/semantic_prep.py``: its trans7time
files, scp lists and JSONL are byte-equal to the JAX module's. It runs on the
host and needs no card.

Behavioral contract (reference: egs/semantic_speaker/bert/local/
prepare_files_for_{aishell_4,alimeeting}.py and
prepare_json_files_for_semantic_speaker.py): corpus TextGrid annotations
(one tier per speaker) become per-utterance trans7time files; sentence-level
sliding windows over each transcript become JSON examples for
(a) dialogue detection — window text + is-multi-speaker label — and
(b) speaker-turn detection — window text + speaker-change char positions.

Output lines carry BOTH the reference's fields (utt_id, conversation_id,
change_point_list, spk_num) and this framework's training fields
(cli/semantic.py: "text" + "label" for dialogue, "text" + per-char
"labels" for turn detection, 1 at each change point).

The TextGrid parser is stdlib-only (no `textgrid` package in this
environment) and reads the standard Praat long format.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import List, Sequence, Tuple

SENTENCE_ENDINGS = ("。", "？", "！")  # 。 ？ ！


# --------------------------------------------------------------------------
# TextGrid -> trans7time
# --------------------------------------------------------------------------

def parse_textgrid(path: str) -> List[Tuple[str, float, float, str]]:
    """Praat long-format TextGrid -> [(tier_name, xmin, xmax, text), ...]
    for non-empty interval texts, in file order.
    (reference: prepare_files_for_alimeeting.py solve_textgrid:25-44)"""
    entries = []
    tier = None
    xmin = xmax = None
    with open(path, encoding="utf-8", errors="replace") as f:
        for raw in f:
            line = raw.strip()
            m = re.match(r'name\s*=\s*"(.*)"', line)
            if m:
                tier = m.group(1)
                continue
            m = re.match(r"xmin\s*=\s*([0-9.eE+-]+)", line)
            if m:
                xmin = float(m.group(1))
                continue
            m = re.match(r"xmax\s*=\s*([0-9.eE+-]+)", line)
            if m:
                xmax = float(m.group(1))
                continue
            m = re.match(r'text\s*=\s*"(.*)"\s*$', line)
            if m and tier is not None:
                text = m.group(1).replace('""', '"').strip()
                if text:
                    entries.append((tier, xmin, xmax, text))
    return entries


def textgrid_to_trans7time(path: str, utt_id: str = ""):
    """Sorted-by-start trans7time list from a TextGrid."""
    del utt_id  # kept for signature parity with the reference helper
    return sorted(parse_textgrid(path), key=lambda x: x[1])


# --------------------------------------------------------------------------
# trans7time -> sentence windows
# --------------------------------------------------------------------------

def split_trans7time(trans7time_list: Sequence) -> List[Tuple[str, str, int]]:
    """(spk, segment_text) -> [(spk, sentence, len)], splitting on 。？！.
    (reference: prepare_json_files_for_semantic_speaker.py:33-48)"""
    out = []
    for spk_id, _st, _ed, content in trans7time_list:
        buf = ""
        for ch in str(content):
            buf += ch
            if ch in SENTENCE_ENDINGS:
                out.append((spk_id, buf, len(buf)))
                buf = ""
        if buf:
            out.append((spk_id, buf, len(buf)))
    return out


def _window(spk_sentences, start: int, sentence_length: int):
    """Accumulate sentences from ``start`` until >= sentence_length chars.
    Returns (text, change_points, spk_num, next_probe_index)."""
    text = ""
    total = 0
    spk_map = {}
    change_points = []
    last = None
    j = start
    while j < len(spk_sentences):
        spk, sent, n = spk_sentences[j]
        if spk not in spk_map:
            spk_map[spk] = len(spk_map)
        idx = spk_map[spk]
        if last is not None and last != idx:
            change_points.append(total)
        last = idx
        text += sent
        total += n
        if total >= sentence_length:
            break
        j += 1
    return text, change_points, len(spk_map), j


def _advance(spk_sentences, i: int, sentence_shift: int) -> int:
    total = 0
    j = i + 1
    while j < len(spk_sentences):
        total += spk_sentences[j][2]
        if total >= sentence_shift:
            break
        j += 1
    return j


def build_windows(utt_id: str, trans7time_list: Sequence,
                  sentence_length: int = 96,
                  sentence_shift: int = 32) -> List[dict]:
    """Sliding sentence windows with speaker-change annotations.
    (reference: build_{dialogue,speaker_turn}_detection_from_trans7time_
    shift_windows — both walk the same windows; one emission serves both
    tasks.) The final window is right-anchored at the transcript end, like
    the reference's reversed tail pass."""
    spk_sentences = split_trans7time(trans7time_list)
    if not spk_sentences:
        return []
    windows = []
    i = 0
    index = 0
    while i < len(spk_sentences):
        text, change_points, spk_num, _ = _window(
            spk_sentences, i, sentence_length)
        windows.append({
            "utt_id": utt_id,
            "conversation_id": f"{utt_id}_{index + 1}",
            "sentence": text,
            "change_point_list": change_points,
            "spk_num": spk_num,
        })
        index += 1
        i = _advance(spk_sentences, i, sentence_shift)
    windows = windows[:-1]

    # right-anchored tail window (reference: the reversed accumulation pass)
    total = 0
    start = len(spk_sentences) - 1
    while start > 0 and total + spk_sentences[start][2] < sentence_length:
        total += spk_sentences[start][2]
        start -= 1
    text, change_points, spk_num, _ = _window(spk_sentences, start,
                                              sentence_length=10 ** 9)
    windows.append({
        "utt_id": utt_id,
        "conversation_id": f"{utt_id}_{index + 1}",
        "sentence": text,
        "change_point_list": change_points,
        "spk_num": spk_num,
    })
    return windows


def to_dialogue_example(win: dict) -> dict:
    return {**win, "text": win["sentence"], "label": int(win["spk_num"] > 1)}


def to_turn_example(win: dict) -> dict:
    labels = [0] * len(win["sentence"])
    for p in win["change_point_list"]:
        if 0 <= p < len(labels):
            labels[p] = 1
    return {**win, "text": win["sentence"], "labels": labels}


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def main(argv=None):
    p = argparse.ArgumentParser(
        description="Prepare semantic-speaker JSONL from TextGrids or "
                    "trans7time files")
    sub = p.add_subparsers(dest="cmd", required=True)

    tg = sub.add_parser("textgrid", help="TextGrid dir -> trans7time + scp")
    tg.add_argument("--textgrid_dir", required=True)
    tg.add_argument("--out_dir", required=True)
    tg.add_argument("--scp", required=True)

    js = sub.add_parser("json", help="trans7time scp -> task JSONL")
    js.add_argument("--trans7time_scp", required=True)
    js.add_argument("--dialogue_out", default=None)
    js.add_argument("--turn_out", default=None)
    js.add_argument("--sentence_length", type=int, default=96)
    js.add_argument("--sentence_shift", type=int, default=32)

    args = p.parse_args(argv)
    from speaker3d_tpu_torch.utils.fileio import (
        load_trans7time_list,
        load_wav_scp,
        write_trans7time_list,
    )

    if args.cmd == "textgrid":
        os.makedirs(args.out_dir, exist_ok=True)
        scp = {}
        for name in sorted(os.listdir(args.textgrid_dir)):
            if not name.lower().endswith(".textgrid"):
                continue
            utt_id = os.path.splitext(name)[0]
            t7t = textgrid_to_trans7time(
                os.path.join(args.textgrid_dir, name), utt_id)
            out = os.path.join(args.out_dir, f"{utt_id}.trans7time")
            write_trans7time_list(out, t7t)
            scp[utt_id] = out
        with open(args.scp, "w") as f:
            for k, v in scp.items():
                f.write(f"{k} {v}\n")
        print(f"{len(scp)} trans7time files -> {args.out_dir}")
        return 0

    scp = load_wav_scp(args.trans7time_scp)
    n_dialogue = n_turn = 0
    fd = open(args.dialogue_out, "w") if args.dialogue_out else None
    ft = open(args.turn_out, "w") if args.turn_out else None
    try:
        for utt_id, path in scp.items():
            wins = build_windows(utt_id, load_trans7time_list(path),
                                 args.sentence_length, args.sentence_shift)
            for w in wins:
                if fd:
                    fd.write(json.dumps(to_dialogue_example(w),
                                        ensure_ascii=False) + "\n")
                    n_dialogue += 1
                if ft:
                    ft.write(json.dumps(to_turn_example(w),
                                        ensure_ascii=False) + "\n")
                    n_turn += 1
    finally:
        if fd:
            fd.close()
        if ft:
            ft.close()
    print(f"dialogue examples: {n_dialogue}, turn examples: {n_turn}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
