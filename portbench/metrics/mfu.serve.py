"""Share of the card's peak in the untraced part of the window: the
operations of the requested images only (committed counts, by precision,
each over its peak: one request's fixed part and one part per requested
row), over the wall time of that part. Bucket padding is not counted."""

from portbench.peaks import seconds_at_peak


def read(run):
    if not run["plain_images"]:
        return None
    counts = run["counts"]["serve"]
    at_peak = (seconds_at_peak(counts["per_image_flops"]) * run["plain_images"]
               + seconds_at_peak(counts["per_request_flops"]) * run["plain_requests"])
    return 100.0 * at_peak / run["plain_s"]
