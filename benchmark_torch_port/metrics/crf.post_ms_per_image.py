"""The VOC post-process's host-clock ms an image: the benchmark's spans
around each ``Evaluator.voc_post_device`` call in the window (upsample,
softmax, CRF, argmax, and the copy of the labels to the host, which waits
for the card) over the images they refined."""


def read(r: dict):
    spans = r.get("post_spans")
    if r.get("kind") != "eval" or not spans:
        return None
    images = sum(len(sizes) for _, sizes in spans)
    return 1e3 * sum(s for s, _ in spans) / images if images else None
