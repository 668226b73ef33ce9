/* Native evaluation kernels (host side) of the video-AP evaluator.
 *
 * The port's copy of vnext_tpu/evaluation/csrc/rle_ops.c: the per-pair RLE
 * intersection / union run-merge, the batched tube IoU and the greedy
 * detection-to-ground-truth matching that dominate mAP accumulation (the
 * analogue of detectron2's C++ COCOeval fast path). Compiled as a plain C
 * shared library by evaluation/native.py and bound with ctypes.
 */

#include <stdint.h>
#include <stddef.h>
#include <stdlib.h>

/* Merge two column-major RLE count sequences, accumulating intersection and
 * union pixel counts. Counts alternate runs of 0s and 1s starting with 0s. */
void rle_intersection_union(
    const int64_t* ca, int64_t na,
    const int64_t* cb, int64_t nb,
    double* out_inter, double* out_union)
{
    double inter = 0.0, uni = 0.0;
    int64_t ia = 0, ib = 0;
    int va = 0, vb = 0;
    double rem_a = na > 0 ? (double)ca[0] : 0.0;
    double rem_b = nb > 0 ? (double)cb[0] : 0.0;
    double total = 0.0;
    for (int64_t i = 0; i < na; ++i) total += (double)ca[i];
    double pos = 0.0;

    while (pos < total && ia < na && ib < nb) {
        double step = rem_a < rem_b ? rem_a : rem_b;
        if (va && vb) inter += step;
        if (va || vb) uni += step;
        rem_a -= step;
        rem_b -= step;
        pos += step;
        if (rem_a <= 0.0) {
            ia += 1;
            va ^= 1;
            rem_a = ia < na ? (double)ca[ia] : 1e300;
        }
        if (rem_b <= 0.0) {
            ib += 1;
            vb ^= 1;
            rem_b = ib < nb ? (double)cb[ib] : 1e300;
        }
    }
    *out_inter = inter;
    *out_union = uni;
}

/* Sum of the 1-runs (mask area). */
double rle_area(const int64_t* counts, int64_t n)
{
    double area = 0.0;
    for (int64_t i = 1; i < n; i += 2) area += (double)counts[i];
    return area;
}

/* Batched pairwise tube IoU.
 * For D detections x G ground truths over T frames:
 *   all RLEs are flattened into `counts` with offsets/lengths per (item, frame);
 *   absent frames have length 0. iscrowd GTs use detection-area denominator.
 * Output: iou[D*G] row-major. */
void tube_iou_matrix(
    const int64_t* counts,
    const int64_t* det_off, const int64_t* det_len,   /* [D*T] */
    const int64_t* gt_off, const int64_t* gt_len,     /* [G*T] */
    const uint8_t* gt_iscrowd,                        /* [G] */
    int64_t D, int64_t G, int64_t T,
    double* iou_out)
{
    for (int64_t d = 0; d < D; ++d) {
        for (int64_t g = 0; g < G; ++g) {
            double inter = 0.0, uni = 0.0, det_area = 0.0;
            for (int64_t t = 0; t < T; ++t) {
                const int64_t* ca = counts + det_off[d * T + t];
                int64_t na = det_len[d * T + t];
                const int64_t* cb = counts + gt_off[g * T + t];
                int64_t nb = gt_len[g * T + t];
                if (na > 0) det_area += rle_area(ca, na);
                if (na == 0 && nb == 0) continue;
                if (na == 0) { uni += rle_area(cb, nb); continue; }
                if (nb == 0) { uni += rle_area(ca, na); continue; }
                double i2, u2;
                rle_intersection_union(ca, na, cb, nb, &i2, &u2);
                inter += i2;
                uni += u2;
            }
            double denom = gt_iscrowd[g] ? det_area : uni;
            iou_out[d * G + g] = denom > 0.0 ? inter / denom : 0.0;
        }
    }
}

/* Greedy COCO-style detection->GT matching at T IoU thresholds.
 *
 * The analogue of the reference's cocoeval.cpp COCOevalEvaluateImages inner
 * loop (csrc/cocoeval/cocoeval.cpp MatchDetectionsToGt; python semantics in
 * ytvoseval.py evaluateVid): detections arrive sorted by descending score,
 * GTs sorted ignore-LAST (the caller must enforce this — the early 'break'
 * below relies on it, exactly as pycocotools relies on its gtind argsort);
 * each detection takes the best GT above the threshold. An already-matched
 * GT may only be re-matched when it is a crowd GT.
 *
 * iou:        [D*G] row-major (columns in the ignore-sorted GT order)
 * gt_ignore:  [G] 0/1 (iscrowd OR area-out-of-range)
 * iscrowd:    [G] 0/1 (crowd GTs may absorb multiple detections)
 * thrs:       [T]
 * matched:    out [T*D] 0/1 (matched a non-ignored GT)
 * ignored:    out [T*D] 0/1 (matched an ignored GT -> drop from PR)
 */
void match_greedy(
    const double* iou, int64_t D, int64_t G,
    const uint8_t* gt_ignore, const uint8_t* iscrowd,
    const double* thrs, int64_t T,
    uint8_t* matched, uint8_t* ignored)
{
    unsigned char* gt_matched = (unsigned char*)malloc((size_t)(G > 0 ? G : 1));
    for (int64_t ti = 0; ti < T; ++ti) {
        for (int64_t g = 0; g < G; ++g) gt_matched[g] = 0;
        double thr = thrs[ti];
        double eps_cap = 1.0 - 1e-10;
        for (int64_t d = 0; d < D; ++d) {
            double best_iou = thr < eps_cap ? thr : eps_cap;
            int64_t best_gi = -1;
            for (int64_t g = 0; g < G; ++g) {
                if (gt_matched[g] && !iscrowd[g]) continue;
                if (best_gi > -1 && !gt_ignore[best_gi] && gt_ignore[g]) break;
                if (iou[d * G + g] >= best_iou) {
                    best_iou = iou[d * G + g];
                    best_gi = g;
                }
            }
            if (best_gi > -1) {
                matched[ti * D + d] = (uint8_t)(!gt_ignore[best_gi]);
                ignored[ti * D + d] = (uint8_t)(gt_ignore[best_gi]);
                gt_matched[best_gi] = 1;
            }
        }
    }
    free(gt_matched);
}
