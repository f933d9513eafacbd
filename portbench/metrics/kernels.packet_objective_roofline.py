"""One captured value and gradient of the front-end packet objective at the
cell's packet shape: the least time its work allows (pb/roofline.py) over
its replayed time, in percent; traced runs on a card in the table only."""

from pb import roofline


def read(rec):
    obj = rec.get("objectives", {}).get("packet")
    if obj is None:
        return None
    return roofline.share_pct(obj["work"], roofline.peaks(rec.get("device_kind", "")),
                              obj["seconds"])
