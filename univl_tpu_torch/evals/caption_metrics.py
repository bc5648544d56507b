"""Caption metrics: BLEU-1..4, ROUGE-L, CIDEr-D, METEOR.

The port's own copy of ``univl_tpu/evals/caption_metrics.py`` (pure Python;
``nltk`` optional), unchanged, so the caption fine-tuning entry point scores
and picks its best epoch as the JAX package does.

The reference scores captions through the external `nlg-eval` package
(main_task_caption.py:12,612-615), which wraps the MSCOCO caption scorers
(Java METEOR included). Here the scorers are reimplemented in pure Python
from the published algorithms:

  - BLEU: corpus-level, closest-reference-length brevity penalty
          (Papineni et al. 2002; coco-caption accumulation semantics)
  - ROUGE-L: LCS F-measure with beta=1.2, max over refs, corpus mean
  - CIDEr-D: tf-idf 1..4-gram cosine with length penalty sigma=6, x10
  - METEOR: pure-Python METEOR 1.5 (Denkowski & Lavie 2014) — exact +
    Snowball-stem matchers (the SAME stemmer the Java jar uses for English,
    via nltk), module weights 1.0/0.6, English rank-task parameters
    alpha=.85 beta=.2 gamma=.6 delta=.75, content/function-word weighting,
    chunk-minimizing alignment, corpus-level aggregation of sufficient
    statistics. ALL FOUR matcher modules are implemented: the
    WordNet-synonym matcher (w=.8) takes a pluggable synonym table
    (``meteor(..., synonyms=...)``) and the paraphrase-table matcher
    (w=.6, phrase spans) a pluggable phrase table
    (``meteor(..., paraphrases=...)``). The DATA files themselves (WordNet
    corpus, paraphrase-en.gz) are unavailable offline, so the default path
    runs exact+stem only — ``load_wordnet_synonyms()`` /
    ``load_meteor_paraphrases()`` plug them in automatically if they ever
    appear on disk ($UNIVL_TPU_METEOR_PARAPHRASES for the phrase table).
    Scores without those tables are a LOWER BOUND on Java METEOR (extra
    matchers only add matches); the deficit is MEASURED against an
    exhaustive-alignment oracle on a labeled fixture set in
    the JAX package's tests/test_meteor_divergence.py and recorded in
    docs/PARITY.md. See tests/test_evals.py for hand-computed formula fixtures.

Inputs: hyps: list[str]; refs: list[list[str]] (multi-reference per row,
reference assembles these for MSRVTT at main_task_caption.py:599-607).
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


# --------------------------------------------------------------------- #
# BLEU
# --------------------------------------------------------------------- #
def bleu(refs: List[List[str]], hyps: List[str], max_n: int = 4) -> List[float]:
    tiny, small = 1e-15, 1e-9
    correct = [0.0] * max_n
    guess = [0.0] * max_n
    hyp_len = 0.0
    ref_len = 0.0
    for refs_i, hyp in zip(refs, hyps):
        h = hyp.split()
        rs = [r.split() for r in refs_i]
        hyp_len += len(h)
        # closest reference length (ties -> shorter)
        ref_len += min((abs(len(r) - len(h)), len(r)) for r in rs)[1]
        for n in range(1, max_n + 1):
            hc = _ngrams(h, n)
            max_rc: Counter = Counter()
            for r in rs:
                rc = _ngrams(r, n)
                for g, c in rc.items():
                    if c > max_rc[g]:
                        max_rc[g] = c
            clipped = sum(min(c, max_rc[g]) for g, c in hc.items())
            correct[n - 1] += clipped
            guess[n - 1] += max(0, len(h) - n + 1)

    ratio = hyp_len / (ref_len + small)
    bp = 1.0 if ratio > 1.0 else math.exp(1.0 - 1.0 / (ratio + small)) if ratio > 0 else 0.0
    scores = []
    logsum = 0.0
    for n in range(max_n):
        p = (correct[n] + tiny) / (guess[n] + small)
        logsum += math.log(p)
        scores.append(bp * math.exp(logsum / (n + 1)))
    return scores


# --------------------------------------------------------------------- #
# ROUGE-L
# --------------------------------------------------------------------- #
def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y else max(prev[j], cur[-1]))
        prev = cur
    return prev[-1]


def rouge_l(refs: List[List[str]], hyps: List[str], beta: float = 1.2) -> float:
    total = 0.0
    for refs_i, hyp in zip(refs, hyps):
        h = hyp.split()
        best = 0.0
        for r in refs_i:
            rt = r.split()
            lcs = _lcs_len(h, rt)
            if lcs == 0:
                continue
            p = lcs / len(h) if h else 0.0
            rec = lcs / len(rt) if rt else 0.0
            if p > 0 and rec > 0:
                f = ((1 + beta**2) * p * rec) / (rec + beta**2 * p)
                best = max(best, f)
        total += best
    return total / max(len(hyps), 1)


# --------------------------------------------------------------------- #
# CIDEr-D
# --------------------------------------------------------------------- #
def cider_d(
    refs: List[List[str]], hyps: List[str], max_n: int = 4, sigma: float = 6.0
) -> float:
    # document frequency over reference sets (per image)
    df: Dict[tuple, float] = defaultdict(float)
    ref_counts = []
    for refs_i in refs:
        per_image = set()
        counts_i = []
        for r in refs_i:
            toks = r.split()
            cnts = {}
            for n in range(1, max_n + 1):
                for g, c in _ngrams(toks, n).items():
                    cnts[g] = c
                    per_image.add(g)
            counts_i.append((cnts, len(toks)))
        ref_counts.append(counts_i)
        for g in per_image:
            df[g] += 1.0

    log_num_images = math.log(max(len(refs), 1))

    def vec(cnts: Dict[tuple, int]):
        v = [defaultdict(float) for _ in range(max_n)]
        norm = [0.0] * max_n
        for g, c in cnts.items():
            idf = log_num_images - math.log(max(1.0, df[g]))
            n = len(g) - 1
            v[n][g] = c * idf
            norm[n] += v[n][g] ** 2
        return v, [math.sqrt(x) for x in norm]

    total = 0.0
    for refs_i_counts, hyp in zip(ref_counts, hyps):
        toks = hyp.split()
        hc: Dict[tuple, int] = {}
        for n in range(1, max_n + 1):
            for g, c in _ngrams(toks, n).items():
                hc[g] = c
        hv, hnorm = vec(hc)
        score_i = 0.0
        for rc, rlen in refs_i_counts:
            rv, rnorm = vec(rc)
            delta = len(toks) - rlen
            for n in range(max_n):
                num = 0.0
                for g, w in hv[n].items():
                    # CIDEr-D: clip hyp tf-idf to ref tf-idf
                    num += min(w, rv[n].get(g, 0.0)) * rv[n].get(g, 0.0)
                denom = hnorm[n] * rnorm[n]
                val = num / denom if denom > 0 else 0.0
                val *= math.exp(-(delta**2) / (2 * sigma**2))
                score_i += val
        score_i /= max(len(refs_i_counts), 1) * max_n
        total += score_i
    return 10.0 * total / max(len(hyps), 1)


# --------------------------------------------------------------------- #
# METEOR 1.5 (Denkowski & Lavie 2014), exact + stem matchers
# --------------------------------------------------------------------- #
def _stemmer():
    """Snowball English — the stemmer METEOR's Java jar uses for 'en'.
    nltk ships it as pure code (no corpus download). Falls back to identity
    (exact-only matching) if nltk is somehow absent."""
    try:
        from nltk.stem.snowball import SnowballStemmer

        return SnowballStemmer("english").stem
    except Exception:  # pragma: no cover
        return lambda w: w


_STEM = None

# English closed-class function words (approximation of METEOR's
# corpus-derived function.words list: articles, prepositions, conjunctions,
# pronouns, auxiliaries, common adverbial particles). Function words get
# weight (1 - delta), content words delta.
_FUNCTION_WORDS = frozenset(
    """a an the this that these those some any each every no all both few
    many much more most other another such what which who whom whose i you
    he she it we they me him her us them my your his its our their mine
    yours hers ours theirs myself yourself himself herself itself ourselves
    themselves be am is are was were been being have has had having do does
    did doing will would shall should may might can could must ought need
    of in on at by for with about against between into through during
    before after above below to from up down out off over under again
    further then once here there when where why how and or but nor so yet
    if because as until while although though since unless whether not only
    just very too also than own same s t don now""".split()
)

# METEOR 1.5 English rank-task parameters and matcher weights
_M15 = dict(alpha=0.85, beta=0.2, gamma=0.6, delta=0.75,
            w_exact=1.0, w_stem=0.6, w_syn=0.8, w_para=0.6)

# Synonym table type: word -> set of synset ids (any hashable). Two words
# synonym-match when their id sets intersect (METEOR's "share a WordNet
# synset" rule, Denkowski & Lavie 2014 §2.1).
SynTable = Dict[str, frozenset]

# Paraphrase table type: symmetric phrase pairs (token tuples), the METEOR
# paraphrase module's db rows (Denkowski & Lavie 2014 §2.1, w=.6); e.g.
# (("put", "in"), ("add",)). Matched in BOTH directions.
ParaTable = Sequence[tuple]


def load_wordnet_synonyms() -> "SynTable | None":
    """Build a synonym table from the nltk WordNet corpus, or None if the
    corpus data is not on disk (the offline-image case — nltk the *code* is
    installed but `wordnet` the *data file* is absent; verified round 2).
    When data is present, meteor() picks this up automatically via
    compute_caption_metrics, restoring the Java jar's w=.8 synonym stage."""
    try:
        from nltk.corpus import wordnet

        table: Dict[str, set] = {}
        for syn in wordnet.all_synsets():
            name = syn.name()
            for lemma in syn.lemma_names():
                table.setdefault(lemma.lower().replace("_", " "), set()).add(name)
        return {w: frozenset(s) for w, s in table.items()}
    except LookupError:  # corpus data absent
        return None
    except Exception:  # pragma: no cover - nltk itself missing/broken
        return None


def _word_weight(w: str, delta: float) -> float:
    return (1.0 - delta) if w in _FUNCTION_WORDS else delta


def _candidates(h: List[str], r: List[str], stem,
                synonyms: "SynTable | None" = None) -> Dict[tuple, float]:
    """(i, j) -> matcher weight; a pair matched by several modules counts
    at the FIRST module's weight in METEOR's module order exact > stem >
    synonym (Java aligner semantics — note stem w=.6 outranks synonym w=.8
    in priority despite the lower weight)."""
    cand: Dict[tuple, float] = {}
    hs = [stem(w) for w in h]
    rs = [stem(w) for w in r]
    empty = frozenset()
    hsyn = [synonyms.get(w, empty) for w in h] if synonyms else None
    for i, hw in enumerate(h):
        for j, rw in enumerate(r):
            if hw == rw:
                cand[(i, j)] = _M15["w_exact"]
            elif hs[i] == rs[j]:
                cand[(i, j)] = _M15["w_stem"]
            elif hsyn is not None and hsyn[i] and not hsyn[i].isdisjoint(
                    synonyms.get(rw, empty)):
                cand[(i, j)] = _M15["w_syn"]
    return cand


def _phrase_candidates(h: List[str], r: List[str],
                       paraphrases: "ParaTable | None") -> List[tuple]:
    """Paraphrase-module candidates as spans (i, li, j, lj, w): hyp span
    [i, i+li) matches ref span [j, j+lj) when they realize the two sides of
    a paraphrase-table row (both directions)."""
    if not paraphrases:
        return []
    out = []
    for pa, pb in paraphrases:
        for xa, xb in ((tuple(pa), tuple(pb)), (tuple(pb), tuple(pa))):
            for i in range(len(h) - len(xa) + 1):
                if tuple(h[i:i + len(xa)]) != xa:
                    continue
                for j in range(len(r) - len(xb) + 1):
                    if tuple(r[j:j + len(xb)]) == xb:
                        out.append((i, len(xa), j, len(xb), _M15["w_para"]))
    return out


def _align(h: List[str], r: List[str], stem,
           synonyms: "SynTable | None" = None,
           paraphrases: "ParaTable | None" = None):
    """Beam search over hyp positions: maximize total matcher weight
    (phrase matches score w * (li + lj) / 2, reducing to w for word
    matches), then minimize chunks (the Java aligner's objective). Returns
    match list of spans [(i, li, j, lj, w_mod)]."""
    by_i: Dict[int, List[tuple]] = {}
    for (i, j), w in _candidates(h, r, stem, synonyms).items():
        by_i.setdefault(i, []).append((i, 1, j, 1, w))
    for c in _phrase_candidates(h, r, paraphrases):
        by_i.setdefault(c[0], []).append(c)
    # beams_at[i]: states at hyp position i —
    # (used_ref frozenset, total_w, chunks, matches tuple of spans)
    WIDTH = 16
    n = len(h)
    beams_at: Dict[int, List[tuple]] = {0: [(frozenset(), 0.0, 0, ())]}
    for i in range(n):
        here = beams_at.pop(i, [])
        if not here:
            continue
        here.sort(key=lambda s: (-s[1], s[2]))
        here = here[:WIDTH]

        def emit(pos, st):
            beams_at.setdefault(pos, []).append(st)

        for used, tw, ch, ms in here:
            emit(i + 1, (used, tw, ch, ms))  # skip hyp word i
            for (ci, li, j, lj, w) in by_i.get(i, ()):
                span = frozenset(range(j, j + lj))
                if used & span:
                    continue
                contiguous = (
                    ms
                    and ms[-1][0] + ms[-1][1] == ci
                    and ms[-1][2] + ms[-1][3] == j
                )
                emit(i + li, (
                    used | span,
                    tw + w * (li + lj) / 2.0,
                    ch + (0 if contiguous else 1),
                    ms + ((ci, li, j, lj, w),),
                ))
    final = beams_at.get(n, [])
    final.sort(key=lambda s: (-s[1], s[2]))
    return list(final[0][3]) if final else []


def _segment_stats(h: List[str], r: List[str], stem, delta: float,
                   synonyms: "SynTable | None" = None,
                   paraphrases: "ParaTable | None" = None):
    """Sufficient statistics for one (hyp, ref) pair. Spans generalize the
    word-match stats: a module match covering spans (li, lj) contributes
    w * sum(word weights) on each side and (li + lj) / 2 matched words."""
    matches = _align(h, r, stem, synonyms, paraphrases)
    wp = sum(
        w * sum(_word_weight(h[i + t], delta) for t in range(li))
        for i, li, j, lj, w in matches
    )
    wr = sum(
        w * sum(_word_weight(r[j + t], delta) for t in range(lj))
        for i, li, j, lj, w in matches
    )
    lh = sum(_word_weight(w, delta) for w in h)
    lr = sum(_word_weight(w, delta) for w in r)
    cov_h = sum(li for i, li, j, lj, w in matches)
    cov_r = sum(lj for i, li, j, lj, w in matches)
    chunks = 0
    prev = None
    for i, li, j, lj, _ in matches:
        if prev is None or not (i == prev[0] + prev[1] and j == prev[2] + prev[3]):
            chunks += 1
        prev = (i, li, j, lj)
    # exact full match in a single chunk -> no fragmentation (Java special
    # case: a perfectly contiguous total alignment is unpenalized)
    if chunks == 1 and cov_h == len(h) and cov_r == len(r) == len(h):
        chunks = 0
    return dict(wp=wp, wr=wr, lh=lh, lr=lr,
                chunks=chunks, m=(cov_h + cov_r) / 2.0)


def _meteor_from_stats(s, alpha: float, beta: float, gamma: float) -> float:
    if s["lh"] <= 0 or s["lr"] <= 0 or s["wp"] <= 0 or s["wr"] <= 0:
        return 0.0
    p = s["wp"] / s["lh"]
    r = s["wr"] / s["lr"]
    fmean = p * r / (alpha * p + (1 - alpha) * r)
    frag = (s["chunks"] / s["m"]) if s["m"] > 0 else 0.0
    return fmean * (1.0 - gamma * frag ** beta)


def meteor(
    refs: List[List[str]], hyps: List[str],
    alpha: float = _M15["alpha"], beta: float = _M15["beta"],
    gamma: float = _M15["gamma"], delta: float = _M15["delta"],
    synonyms: "SynTable | None" = None,
    paraphrases: "ParaTable | None" = None,
) -> float:
    """Corpus-level METEOR: per segment pick the best-scoring reference,
    aggregate its sufficient statistics, apply the formula to the totals
    (the Java scorer's system-level aggregation). ``synonyms`` plugs in the
    w=.8 WordNet-synonym matcher (see load_wordnet_synonyms);
    ``paraphrases`` the w=.6 phrase-table matcher (see
    load_meteor_paraphrases) — with both plugged, the full four-module
    Java METEOR matcher stack runs."""
    global _STEM
    if _STEM is None:
        _STEM = _stemmer()
    agg = dict(wp=0.0, wr=0.0, lh=0.0, lr=0.0, chunks=0.0, m=0.0)
    for refs_i, hyp in zip(refs, hyps):
        h = hyp.lower().split()
        best_s, best_score = None, -1.0
        for ref in refs_i:
            s = _segment_stats(h, ref.lower().split(), _STEM, delta,
                               synonyms, paraphrases)
            score = _meteor_from_stats(s, alpha, beta, gamma)
            if score > best_score:
                best_s, best_score = s, score
        if best_s is not None:
            for k in agg:
                agg[k] += best_s[k]
    return _meteor_from_stats(agg, alpha, beta, gamma)


def load_meteor_paraphrases(path: "str | None" = None) -> "ParaTable | None":
    """Load a METEOR paraphrase table, or None when absent (the
    offline-image default — the METEOR 1.5 ``paraphrase-en.gz`` data file
    is not shipped; verified round 2).

    Accepted formats (``.gz`` transparently decompressed):
      - METEOR 1.5 ``paraphrase-en`` layout: alternating lines
        (phrase_1 / phrase_2 / ...), pairs on consecutive lines
      - TSV: one ``phrase_a<TAB>phrase_b`` pair per line (comment lines
        starting with '#' skipped)
    ``path`` defaults to $UNIVL_TPU_METEOR_PARAPHRASES. When the table is
    present, compute_caption_metrics picks it up automatically, restoring
    the Java jar's fourth (w=.6) matcher stage — the full four-module
    stack then runs in production (pinned against the exhaustive-alignment
    oracle in tests/test_meteor_divergence.py)."""
    import gzip
    import os

    path = path or os.environ.get("UNIVL_TPU_METEOR_PARAPHRASES")
    if not path or not os.path.exists(path):
        return None
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8", errors="replace") as f:
        lines = [ln.rstrip("\n") for ln in f]
    pairs: List[tuple] = []
    if any("\t" in ln for ln in lines[:50] if ln and not ln.startswith("#")):
        for ln in lines:
            if not ln or ln.startswith("#"):
                continue
            a, _, b = ln.partition("\t")
            if a and b:
                pairs.append((tuple(a.lower().split()), tuple(b.lower().split())))
    else:
        flat = [ln for ln in lines if ln and not ln.startswith("#")]
        for i in range(0, len(flat) - 1, 2):
            pairs.append((
                tuple(flat[i].lower().split()),
                tuple(flat[i + 1].lower().split()),
            ))
    return pairs or None


# --------------------------------------------------------------------- #
_WORDNET_SYNONYMS: "SynTable | None | bool" = False  # False = not probed yet
_PARAPHRASES: "ParaTable | None | bool" = False  # False = not probed yet


def _auto_synonyms() -> "SynTable | None":
    """Probe the WordNet corpus ONCE per process; None when absent (the
    offline-image default, where METEOR runs exact+stem)."""
    global _WORDNET_SYNONYMS
    if _WORDNET_SYNONYMS is False:
        _WORDNET_SYNONYMS = load_wordnet_synonyms()
    return _WORDNET_SYNONYMS


def _auto_paraphrases() -> "ParaTable | None":
    """Probe $UNIVL_TPU_METEOR_PARAPHRASES ONCE per process."""
    global _PARAPHRASES
    if _PARAPHRASES is False:
        _PARAPHRASES = load_meteor_paraphrases()
    return _PARAPHRASES


def compute_caption_metrics(refs: List[List[str]], hyps: List[str]) -> Dict[str, float]:
    """Full nlg-eval-style metric dict (reference eval prints these,
    main_task_caption.py:613-615)."""
    b = bleu(refs, hyps)
    return {
        "Bleu_1": b[0],
        "Bleu_2": b[1],
        "Bleu_3": b[2],
        "Bleu_4": b[3],
        "METEOR": meteor(refs, hyps, synonyms=_auto_synonyms(),
                         paraphrases=_auto_paraphrases()),
        "ROUGE_L": rouge_l(refs, hyps),
        "CIDEr": cider_d(refs, hyps),
    }
