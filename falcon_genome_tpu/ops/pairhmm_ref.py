"""NumPy float64 golden model of the PairHMM forward likelihood.

Semantics follow GATK's LoglessPairHMM (the model the reference accelerates
through the Blaze NAM FPGA service behind HaplotypeCaller — SURVEY.md §2
row 25, src/workers/BlazeWorker.cpp):

* states M/I/D with read-position-indexed transitions derived from the
  per-base insertion/deletion gap-open qualities and the gap-continuation
  penalty;
* emission prior: ``1 - err`` on base match (or either base N), ``err/3``
  on mismatch;
* free start anywhere in the haplotype: row 0 of D carries
  ``INITIAL_CONDITION / hap_len``;
* result: ``log10(sum_j M[R][j] + I[R][j]) - log10(INITIAL_CONDITION)``.

This is the correctness oracle for every PairHMM path; float64 with a huge
initial condition never underflows at read scale.
"""
from __future__ import annotations

import numpy as np

BASE_N = 4
LOG10_INITIAL = 300.0  # 10^300 initial condition: far from f64 limits


def _phred_to_prob(q: np.ndarray) -> np.ndarray:
    return np.power(10.0, -q.astype(np.float64) / 10.0)


def pairhmm_logp_single(read_codes: np.ndarray, base_q: np.ndarray,
                        ins_q: np.ndarray, del_q: np.ndarray,
                        gcp: np.ndarray, hap_codes: np.ndarray) -> float:
    """log10 P(read | haplotype) for one pair (unpadded 1-D arrays)."""
    R = len(read_codes)
    H = len(hap_codes)
    ic = 10.0 ** LOG10_INITIAL

    p_err = _phred_to_prob(base_q)
    p_ins = _phred_to_prob(ins_q)
    p_del = _phred_to_prob(del_q)
    p_cont = _phred_to_prob(gcp)

    a_mm = 1.0 - np.minimum(1.0, p_ins + p_del)   # matchToMatch
    a_mi = p_ins                                   # matchToInsertion
    a_md = p_del                                   # matchToDeletion
    a_im = 1.0 - p_cont                            # indelToMatch
    a_ii = p_cont                                  # ins/del continuation

    M = np.zeros((R + 1, H + 1))
    I = np.zeros((R + 1, H + 1))
    D = np.zeros((R + 1, H + 1))
    D[0, :] = ic / H  # free start across the haplotype

    for i in range(1, R + 1):
        rb = read_codes[i - 1]
        err = p_err[i - 1]
        for j in range(1, H + 1):
            hb = hap_codes[j - 1]
            match = (rb == hb) or rb == BASE_N or hb == BASE_N
            prior = (1.0 - err) if match else (err / 3.0)
            M[i, j] = prior * (M[i - 1, j - 1] * a_mm[i - 1]
                               + I[i - 1, j - 1] * a_im[i - 1]
                               + D[i - 1, j - 1] * a_im[i - 1])
            I[i, j] = M[i - 1, j] * a_mi[i - 1] + I[i - 1, j] * a_ii[i - 1]
            D[i, j] = M[i, j - 1] * a_md[i - 1] + D[i, j - 1] * a_ii[i - 1]

    total = M[R, 1:].sum() + I[R, 1:].sum()
    if total <= 0.0:
        return float("-inf")
    return float(np.log10(total) - LOG10_INITIAL)


def pairhmm_logp_ref(read_codes: np.ndarray, base_q: np.ndarray,
                     ins_q: np.ndarray, del_q: np.ndarray, gcp: np.ndarray,
                     read_lens: np.ndarray, hap_codes: np.ndarray,
                     hap_lens: np.ndarray) -> np.ndarray:
    """Batched golden model over padded (B, R) reads × (B, H) haplotypes."""
    B = read_codes.shape[0]
    out = np.zeros(B)
    for b in range(B):
        rl, hl = int(read_lens[b]), int(hap_lens[b])
        out[b] = pairhmm_logp_single(
            read_codes[b, :rl], base_q[b, :rl], ins_q[b, :rl],
            del_q[b, :rl], gcp[b, :rl], hap_codes[b, :hl])
    return out


def pairhmm_logp_ref_batch(read_codes: np.ndarray, base_q: np.ndarray,
                           ins_q, del_q, gcp, read_lens: np.ndarray,
                           hap_codes: np.ndarray,
                           hap_lens: np.ndarray) -> np.ndarray:
    """``pairhmm_logp_ref`` vectorized over pairs, for batches at
    production widths.  Same recurrences in float64: M and I of a row are
    whole-row array expressions over (hap position, pair); only D walks
    along the row.  ins_q/del_q/gcp may be scalars or (B, R) arrays."""
    B, R = read_codes.shape
    H = hap_codes.shape[1]
    rl = np.asarray(read_lens, np.int64)
    hl = np.asarray(hap_lens, np.int64)
    ic = 10.0 ** LOG10_INITIAL

    def plane(q):
        return np.broadcast_to(_phred_to_prob(np.asarray(q)), (B, R))

    p_err, p_ins, p_del, p_cont = (plane(q) for q in
                                   (base_q, ins_q, del_q, gcp))
    a_mm = 1.0 - np.minimum(1.0, p_ins + p_del)
    a_im = 1.0 - p_cont
    hap = hap_codes.T                                   # (H, B)
    M = np.zeros((H + 1, B))
    I = np.zeros((H + 1, B))
    D = np.broadcast_to(ic / hl, (H + 1, B)).copy()     # row 0
    total = np.zeros(B)
    for i in range(1, int(rl.max(initial=0)) + 1):
        rb = read_codes[:, i - 1]
        err = p_err[:, i - 1]
        match = (rb == hap) | (rb == BASE_N) | (hap == BASE_N)
        prior = np.where(match, 1.0 - err, err / 3.0)
        Mi = np.zeros((H + 1, B))
        Ii = np.zeros((H + 1, B))
        Di = np.zeros((H + 1, B))
        Mi[1:] = prior * (M[:-1] * a_mm[:, i - 1]
                          + (I[:-1] + D[:-1]) * a_im[:, i - 1])
        Ii[1:] = M[1:] * p_ins[:, i - 1] + I[1:] * p_cont[:, i - 1]
        for j in range(1, H + 1):
            Di[j] = Mi[j - 1] * p_del[:, i - 1] + Di[j - 1] * p_cont[:, i - 1]
        M, I, D = Mi, Ii, Di
        done = rl == i
        if done.any():
            live = np.arange(1, H + 1)[:, None] <= hl[None, :]
            total[done] = ((M[1:] + I[1:]) * live).sum(axis=0)[done]
    with np.errstate(divide="ignore"):
        return np.where(total > 0.0, np.log10(total) - LOG10_INITIAL,
                        -np.inf)
