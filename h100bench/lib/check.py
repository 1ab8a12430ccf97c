"""The comparison that decides `correct`.

Every image the window started is an answer due. An image that raised,
came back empty or fell back after a search error is a failure. Of the
images that came back, a sample drawn from the seed, always holding the
one with the longest wall, is judged by the plain reference
(h100bench/reference/), which decodes the input and the output itself:

  * codec: the output is a baseline JPEG of the configuration's
    subsampling and of the input's size;
  * metric: the reference's float64 butteraugli distance d_ref of the
    decoded output to the decoded input, held against the quality's
    target (Guetzli's guarantee) as `dist_over_target`, the worst
    d_ref / target - 1 over the judged outputs; and against the distance
    the program reports for the output it chose
    (ProcessStats.final_distance), as the gap |d_ref - d_program| / d_ref.

The numbers compared, each with its limit: `failed` (0), `codec_faults`
(0), and those of `dist_over_target`, `dist_gap` (the widest gap over
the judged outputs) and `dist_gap_mean` (their mean) that the cell's
traffic file gives a limit ("limits"); the others are printed beside
them. The target is met within ScoreJPEG's tolerance (score.cc:23-41):
the search may keep an output a little over it when it is much smaller,
and the program's float32 distance differs from the reference's.
"""

from h100bench.lib import traffic as traffic_mod
from h100bench.reference import distance as ref_distance
from h100bench.reference import jpegdec


def _sample(images, n, seed):
    """Slots to judge: the slot of the longest completed wall first, then
    others in an order drawn from the seed; and each slot's record with
    the longest wall."""
    best = {}
    for im in images:
        if im["out"] is None:
            continue
        cur = best.get(im["slot"])
        if cur is None or im["wall"] > cur["wall"]:
            best[im["slot"]] = im
    if not best:
        return []
    first = max(best.values(), key=lambda im: im["wall"])["slot"]
    rest = sorted(s for s in best if s != first)
    rng = traffic_mod.rng_for(seed, stream=1)
    rest = [rest[i] for i in rng.permutation(len(rest))]
    return [best[s] for s in ([first] + rest)[:n]]


def _numbers(failed, codec, gaps, over, limits):
    """Ordered {name: {"value", "limit"}} of the compared numbers, and
    every reading (compared or not) by name."""
    widest, mean = (max(gaps), sum(gaps) / len(gaps)) if gaps else (0., 0.)
    values = {"dist_over_target": over, "dist_gap": widest,
              "dist_gap_mean": mean}
    numbers = {"failed": {"value": failed, "limit": 0},
               "codec_faults": {"value": codec, "limit": 0}}
    for name, limit in limits.items():
        numbers[name] = {"value": values[name], "limit": limit}
    return numbers, values


def _correct(judged, numbers):
    return (judged > 0 and all(
        n["value"] is not None and n["value"] <= n["limit"]
        for n in numbers.values()))


def judge(images, items, config, traffic, seed, control=None):
    """(correct, numbers, info). numbers: ordered {name: {"value",
    "limit"}}; info: what was judged and every reading. `control`, a
    distance function (h100bench/reference/tf32.py), is put in the
    program's place: its distance of each judged output stands for the
    program's, and info also holds `control_correct` and
    `control_numbers`, the same judgement of those."""
    failed = sum(1 for im in images if im["out"] is None or im["error"]
                 or im["search_error"])
    by_slot = {it["slot"]: it for it in items}
    want = config["output"]["subsampling"]
    target = config["butteraugli_target"]
    codec = 0
    gaps, ctrl = [], []
    over = None
    judged = []
    for im in _sample(images, int(traffic["check"]), seed):
        item = by_slot[im["slot"]]
        if config["input"]["kind"] == "jpeg":
            orig, _ = jpegdec.decode(item["data"])
        else:
            orig = item["rgb"]
        try:
            out, sampling = jpegdec.decode(im["out"])
        except (ValueError, IndexError, KeyError) as e:  # JpegFormatError too
            codec += 1
            judged.append((im["name"], "codec: %s" % e))
            continue
        if sampling != want or out.shape != orig.shape:
            codec += 1
            judged.append((im["name"], "codec: %s %r" % (sampling,
                                                         out.shape)))
            continue
        d_ref = ref_distance.distance(orig, out)
        d_prog = im["distance"]
        # An output without a reported distance reads as a gap of 1e9.
        gaps.append(1e9 if d_prog is None
                    else abs(d_ref - d_prog) / max(d_ref, 1e-12))
        o = d_ref / target - 1.0
        over = o if over is None else max(over, o)
        judged.append((im["name"], d_ref, d_prog))
        if control is not None:
            ctrl.append(abs(d_ref - control(orig, out)) / max(d_ref, 1e-12))
    limits = traffic["limits"]
    numbers, values = _numbers(failed, codec, gaps, over, limits)
    info = {"judged": len(judged), "detail": judged}
    info.update(values)
    if control is not None:
        info["control_numbers"], cvalues = _numbers(failed, codec, ctrl,
                                                    over, limits)
        info["control_correct"] = _correct(len(judged),
                                           info["control_numbers"])
        info["control_gap"] = cvalues["dist_gap"]
        info["control_gap_mean"] = cvalues["dist_gap_mean"]
    return _correct(len(judged), numbers), numbers, info
