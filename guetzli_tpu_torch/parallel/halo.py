"""Row-sharded image ops with an explicit halo exchange.

Port of guetzli_tpu/parallel/halo.py. One image's rows are split over the
ranks of a group (parallel/mesh.py's RowBands); every stage of the
compare is local to a band of rows except the stencils (the blurs, the
8-row windows, the small poolings), which read neighbouring rows. Those
come from the nearest ranks that hold rows, by point-to-point sends and
receives (parallel/dist.py), just before the stage that reads them.

Rows past the image's edge take the stage's own border value:
``sharded_blur`` and ``average5x5`` read zeros there, ``min_square_val``
+inf and the weights' dilation -inf. JAX's ``ppermute`` fills zeros, which
covers its blur only.

Exactness: the blur evaluates each output over the same taps, in the
same order, as the single-device blur, with the border weights of the
whole image sliced to the band; its subsampled rows are the global grid
(a band starts on a multiple of the step). So ``sharded_blur`` equals
ops/blur.blur bit for bit, every sigma, strided ones included (JAX hands
sigma >= 3 to GSPMD, which the port does not have).
"""

import torch
import torch.nn.functional as F

from guetzli_tpu_torch.ops.blur import (_border_weights, blur_step,
                                        gauss_taps, upsample_columns)


class Span:
    """One rank's rows [lo, hi) of an axis of `size` rows split over the
    ranks of `group` (parallel/dist.Group, or None for one rank), with
    every rank's (lo, hi) in `ranges`: any rank can tell what any other
    holds, so both sides of an exchange agree on its rows."""

    def __init__(self, ranges, rank, size, group):
        self.ranges = [tuple(r) for r in ranges]
        self.rank = rank
        self.size = size
        self.group = group
        self.lo, self.hi = self.ranges[rank]

    @property
    def n(self):
        return self.hi - self.lo

    def counts(self):
        return [hi - lo for lo, hi in self.ranges]

    def _nearest(self, rank, step):
        """The nearest rank from `rank` in direction `step` holding rows,
        or None."""
        r = rank + step
        while 0 <= r < len(self.ranges):
            if self.ranges[r][1] > self.ranges[r][0]:
                return r
            r += step
        return None

    def __repr__(self):
        return "Span(%d:%d of %d, rank %d)" % (self.lo, self.hi, self.size,
                                               self.rank)


def halo_exchange_rows(local, halo, fill, span):
    """Rows of the neighbours around this band: local [..., n, W] holds
    rows [span.lo, span.hi) -> [..., up + n + down, W] with `up` rows
    above and `down` below (halo: an int for both, or (up, down)). Rows
    past the image's edge are `fill`. A rank without rows returns its
    empty band as it is, after taking its part in nothing; every rank
    with rows takes part in the exchange with its nearest neighbours that
    hold rows."""
    up, down = (halo, halo) if isinstance(halo, int) else halo
    n = span.n
    if n == 0:
        return local
    above = span._nearest(span.rank, -1)
    below = span._nearest(span.rank, 1)
    sends, recvs = [], []
    tail = tuple(local.shape[:-2]), local.shape[-1]

    def shape(k):
        return tail[0] + (k, tail[1])

    got_up = got_down = 0
    if above is not None and up + down:
        n_above = span.ranges[above][1] - span.ranges[above][0]
        if n_above < up:
            raise ValueError("a halo of %d rows is wider than the band of "
                             "%d above %s" % (up, n_above, span))
        got_up = up
        if min(down, n):
            sends.append((above, local[..., :min(down, n), :]))
        if up:
            recvs.append((above, shape(up), local.dtype))
    if below is not None and up + down:
        n_below = span.ranges[below][1] - span.ranges[below][0]
        got_down = min(down, n_below)
        if got_down < down and span._nearest(below, 1) is not None:
            raise ValueError("a halo of %d rows is wider than the band of "
                             "%d below %s" % (down, n_below, span))
        if min(up, n):
            sends.append((below, local[..., n - min(up, n):, :]))
        if got_down:
            recvs.append((below, shape(got_down), local.dtype))
    got = (span.group.sendrecv(sends, recvs) if sends or recvs else [])
    parts = []
    if up:
        parts.append(local.new_full(shape(up - got_up), fill))
        if got_up:
            parts.append(got.pop(0))
    parts.append(local)
    if got_down:
        parts.append(got.pop(0))
    if down:
        parts.append(local.new_full(shape(down - got_down), fill))
    return torch.cat(parts, dim=-2)


def sharded_blur(band, sigma, border_ratio, span):
    """ops/blur.blur of an image [..., H, W] whose rows are split over
    the ranks: band holds rows [span.lo, span.hi) of span.size = H rows;
    returns the blur's rows there, bit for bit. Every sigma: the rows of
    a strided blur are the global grid's samples, upsampled as the
    single-device blur upsamples them."""
    h, w = span.size, band.shape[-1]
    lead = band.shape[:-2]
    if span.n == 0:
        # No rows, no exchange: the neighbours skip this rank.
        return band.new_zeros(lead + (0, w))
    taps, offset = gauss_taps(sigma)
    step = blur_step(sigma)
    dev = band.device
    jt = torch.as_tensor(taps, device=dev)
    k = jt.shape[0]
    scale_x = torch.as_tensor(_border_weights(w, sigma, border_ratio),
                              device=dev)
    # The horizontal pass is row-local: the band's rows alone.
    x = band.reshape(-1, 1, w)
    p = F.pad(x, (offset, k - 1 - offset))
    t = F.conv1d(p, jt.view(1, 1, k), stride=step)[:, 0, :] * scale_x
    dw = t.shape[-1]
    t = t.reshape(lead + (span.n, dw))
    # The vertical pass reads `offset` rows around each global sample
    # k0 * step .. k1 * step whose upsampled rows fall in the band.
    halo = offset + step - 1
    ext = halo_exchange_rows(t, halo, 0.0, span)
    k0, k1 = span.lo // step, (span.hi - 1) // step
    first = k0 * step - (span.lo - halo) - offset
    last = k1 * step - (span.lo - halo) + offset + 1
    cols = ext[..., first:last, :].transpose(-1, -2).reshape(-1, 1,
                                                             last - first)
    scale_y = torch.as_tensor(
        _border_weights(h, sigma, border_ratio)[k0:k1 + 1], device=dev)
    v = F.conv1d(cols, jt.view(1, 1, k), stride=step)[:, 0, :] * scale_y
    out = v.reshape(lead + (dw, k1 - k0 + 1)).transpose(-1, -2)
    if step > 1:
        rows = torch.arange(span.lo, span.hi, device=dev) // step - k0
        out = out.index_select(-2, rows)
        out = upsample_columns(out, step, w)
    return out.contiguous()


def pmax_scalar(value, group):
    """The max of a scalar tensor over the ranks of `group` (the global
    reduction of ButteraugliScoreFromDiffmap); the value itself on one
    rank."""
    if group is None:
        return value
    return group.all_reduce_max(value.reshape(1))[0]
