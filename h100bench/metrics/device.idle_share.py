"""1 minus the union of the card's kernel, copy and set intervals over the
traced sub-window's wall, in percent."""

UNIT = "%"
LAYER = "device"
MOVES = "mpix_per_s"


def read(rec):
    tr = rec["trace"]
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
