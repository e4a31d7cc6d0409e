"""The VOC post-process against the CRF's roofline, in %: the bytes the
mean field must move for each image at its own size (``work.crf_bytes``)
at HBM's peak, over the time of the post-process spans."""

import work


def read(r: dict):
    spans = r.get("post_spans")
    if r.get("kind") != "eval" or not spans:
        return None
    bound = sum(work.crf_bytes(h, w, r["num_classes"], r["crf_iterations"], r["crf_bi_sxy"],
                               r["crf_bi_srgb"])
                for _, sizes in spans for h, w in sizes) / work.HBM_BYTES_PER_S
    return work.roofline_percent(bound, sum(s for s, _ in spans))
