"""One captured value and gradient of the back-end crop objective on the
window loaded last into a crop program: the least time its work allows
(pb/roofline.py) over its replayed time, in percent; traced runs only."""

from pb import roofline


def read(rec):
    obj = rec.get("objectives", {}).get("window")
    if obj is None:
        return None
    return roofline.share_pct(obj["work"], roofline.peaks(rec.get("device_kind", "")),
                              obj["seconds"])
