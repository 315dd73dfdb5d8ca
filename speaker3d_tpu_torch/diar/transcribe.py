"""Speaker-attributed transcription: ASR word timestamps merged with a
diarization RTTM (host code).

The counterpart of ``speaker3d_tpu/diar/transcribe.py``: the ASR result
gives punctuated ``text``, space-separated ``raw_text`` words and one
``timestamp`` interval per word; words group into sentences at
punctuation; a sentence's main speaker is the RTTM speaker with the largest
overlap; a word keeps the main speaker when it overlaps them, else its own
best overlap, else the previous speaker; consecutive words of one speaker
less than ``merge_gap_s`` apart merge into one attributed utterance. Any
engine that gives the (text, raw_text, timestamp) triple plugs in
(``asr/ctc.py`` is the package's own).
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence

PUNC_PATTERN = r'[,.!?;:"\-—…、，。！？；：“”‘’]'


def words_to_sentences(text: str, raw_text: str,
                       timestamps: Sequence[Sequence[float]]) -> List[list]:
    """Align raw words to the punctuated text and split into sentences.

    Returns [[ [word_with_punct, [st, ed]], ... ], ...]; [] when the ASR
    output is inconsistent (reference behavior: warn and skip the file).
    """
    words = raw_text.split()
    if len(words) != len(timestamps):
        return []
    sentences: List[list] = [[]]
    pt = 0
    for i, wd in enumerate(words):
        cache = ""
        while pt < len(text) and cache.lower().replace(" ", "") != wd.lower():
            cache += text[pt]
            pt += 1
        if cache.lower().replace(" ", "") != wd.lower():
            return []  # malformed pairing of text/raw_text
        while pt < len(text) and (text[pt] == " "
                                  or re.match(PUNC_PATTERN, text[pt])):
            cache += text[pt]
            pt += 1
        sentences[-1].append([cache, [float(timestamps[i][0]),
                                      float(timestamps[i][1])]])
        if cache and re.match(PUNC_PATTERN, cache[-1]) and pt < len(text):
            sentences.append([])
    return [s for s in sentences if s]


def match_spk(words: Sequence[Sequence], fields: Sequence[Sequence]) -> List:
    """Speakers overlapping [first word start, last word end], sorted by
    overlap duration (descending)."""
    if not words:
        return []
    st, ed = words[0][1][0], words[-1][1][1]
    overlap: Dict = {}
    for f_st, f_ed, spk in fields:
        dur = min(ed, f_ed) - max(st, f_st)
        if dur > 0:
            overlap[spk] = overlap.get(spk, 0.0) + dur
    return [s for s, _ in sorted(overlap.items(), key=lambda kv: -kv[1])]


def distribute_speakers(sentences: List[list],
                        fields: Sequence[Sequence],
                        merge_gap_s: float = 2.0) -> List[list]:
    """Assign a speaker per word, then merge runs -> [[text, [st, ed], spk]]."""
    # words before any overlapping segment inherit the first real speaker
    # (the reference's int-0 default would fabricate a label of the wrong
    # type next to the RTTM's string speakers)
    last_spk = fields[0][2] if len(fields) else 0
    for sentence in sentences:
        mains = match_spk(sentence, fields)
        main = mains[0] if mains else last_spk
        for wd in sentence:
            wd_spks = match_spk([wd], fields)
            if main in wd_spks:
                wd.append(main)
            elif wd_spks:
                wd.append(wd_spks[0])
            else:
                wd.append(last_spk)
        last_spk = sentence[-1][2]
    flat = [wd for s in sentences for wd in s]
    if not flat:
        return []
    merged = [[flat[0][0], list(flat[0][1]), flat[0][2]]]
    for text, (st, ed), spk in flat[1:]:
        if spk == merged[-1][2] and st < merged[-1][1][1] + merge_gap_s:
            merged[-1][0] += text
            merged[-1][1][1] = ed
        else:
            merged.append([text, [st, ed], spk])
    return merged


def attribute_transcript(asr_result: Dict, fields: Sequence[Sequence],
                         merge_gap_s: float = 2.0,
                         timestamps_ms: "bool | None" = None) -> List[list]:
    """asr_result: {'text', 'raw_text', 'timestamp' [[st, ed], ...]}.

    ``timestamps_ms``: True = timestamps are milliseconds (the Paraformer
    convention the reference converts unconditionally,
    out_transcription.py:40), False = seconds (the native CTC engine).
    None auto-detects: treated as ms when the last timestamp exceeds 50x
    the diarization span (a knee low enough that ms stamps on short audio
    — e.g. 1000 ms on a 1 s clip — are still converted)."""
    ts = [list(map(float, t)) for t in asr_result["timestamp"]]
    if timestamps_ms is None and ts and fields:
        max_field_end = max(f[1] for f in fields)
        timestamps_ms = ts[-1][1] >= max(10.0, max_field_end) * 50.0
    if timestamps_ms:
        ts = [[a / 1000.0, b / 1000.0] for a, b in ts]
    sentences = words_to_sentences(asr_result["text"],
                                   asr_result["raw_text"], ts)
    return distribute_speakers(sentences, fields, merge_gap_s)
