"""The flagship's teacher-forced rollout under autograd as one
``torch.autograd.Function``, its elementwise work in four CUDA kernels.

Port-only: it replaces no TPU kernel.  The JAX package differentiates its
rollout with ``jax.grad`` and leaves each step's elementwise ops to XLA,
which fuses them.  Under PyTorch's autograd the same rollout is ~50 small
ops a step forward and ~50 backward (the input embedding, the gate sum,
``lstm_pointwise``, Hidden2Normal, the masked update, the teacher-forcing
lanes, and every weight's gradient added in at each of its 19 uses), and
the trainer's loss ~240 more, ~2,400 kernels a train step at batch 8, each
at launch scale.  ``FusedTrainRollout`` runs the grid stage, two products
and two kernels a step forward and a kernel and a product backward, and
takes each weight's gradient once, over all the steps that used it;
``FusedPredictionLoss`` is one kernel forward and one backward.
``LSTM.takes_fused_train`` (``models/lstm.py``) decides where they apply.

It can, because no gradient flows through positions: the grid reads data,
or the primary's detached position in the teacher-forcing lanes.  So
backpropagation through time carries only ``h`` and ``c``.

Forward, step g of T = (T_obs - 1) encoder + n_dec decoder steps, rows R =
S * A, the stack ``xh`` [T + 1, R, E + P + H + 1] holding each step's
``[x | h | 1]``:

1. the grid stage (``grid``: ``models/lstm.py`` passes the name it
   imports, the kernel on the card);
2. ``pre = grid @ W_grid`` (``torch.mm``; the encoder's grids read data
   only, so theirs are made first and multiplied as one product);
3. ``fused_train_in``: ``x = [relu(4 vel W_emb + b_emb) | 0, 0 | relu(pre +
   b_grid)]`` into ``xh[g]``, with ``vel = (obs2 - obs1) * mask``; ``[4 vel,
   1]`` and the mask saved;
4. ``gates = xh[g] @ [W_ih; W_hh; b_ih + b_hh]`` (``torch.mm``: the gate
   bias rides the ones column);
5. ``fused_train_cell``: the i/f/g/o activations, ``c'``, ``h'``, the
   masked update into ``xh[g + 1]`` and ``c[g + 1]``, Hidden2Normal and its
   head, the masked normal, the output position and, where the decoder's
   teacher-forcing chain reads it, the primary's own position and validity
   two steps on (``_set_primary`` of ``models/lstm.py``).  The activations,
   ``tanh(c')`` and the head's sigmoids are saved.

Backward, g from T - 1 down to 0: ``fused_train_cell_backward`` takes the
step's gradients of ``rel_pred`` and ``pred`` and the carried ``dh``, ``dc``
and gives the gates' gradient, the raw head's and the carried ``dh`` (kept
where the agent is absent) and ``dc``; ``dh += dgates @ W_hh^T``
(``torch.mm``) for step g - 1.  Then once a rollout: ``dx = dgates @
W_ih^T`` for each cell's steps (two ``torch.mm``), ``fused_train_in_backward``
(both relu masks, in place), and each weight's gradient as one product over
all its steps; the biases of the gates, the embedding and Hidden2Normal are
the ones column's row of their products, ``b_grid``'s one column sum.  No
reduction uses atomics: two runs give the same bits, and so do a CUDA graph
replay and an eager step.

Each kernel (``csrc/fused_train.cu``) has its plain version here, which
the wrapper runs for tensors on the CPU, so that the CPU tests exercise
this Function whole, hand-written backward included; on the card the
wrapper launches the kernel or raises.  The widths (embedding, pool,
hidden) are taken at run time.  Each wrapper counts its launches in its
``launches`` attribute (``trainers/graphs.COUNTERS``).
"""

import math
from typing import Callable, Optional, Tuple

import torch


# ------------------------------------------------------------ plain versions
def fused_train_in_plain(obs1, obs2, present1, present2, pre, w_emb, b_emb, b_grid, xh, v4,
                         mask) -> None:
    """Step 3 of a rollout, written into ``xh`` [R, ld] (the x part and the
    ones column), ``v4`` [R, 3] (``[4 vel, 1]``) and ``mask`` [R]."""
    lin, pool = w_emb.shape[1], pre.shape[1]
    m = present1 & present2
    vel = ((obs2 - obs1) * m[..., None]).reshape(-1, 2) * 4.0
    xh[:, :lin] = torch.relu(vel @ w_emb + b_emb)
    xh[:, lin:lin + 2] = 0.0
    xh[:, lin + 2:lin + 2 + pool] = torch.relu(pre + b_grid)
    xh[:, -1] = 1.0
    v4[:, :2] = vel
    v4[:, 2] = 1.0
    mask.copy_(m.reshape(-1))


def fused_train_cell_plain(gates, xh, c, mask, obs2, w_h2n, b_h2n, xh_next, c_next, act, tc,
                           sig, rel, pred, chain=None) -> None:
    """Step 5 of a rollout, written into its outputs: ``xh_next``'s h part
    and ones column, ``c_next``, ``act`` [R, 4H] (sigmoid i, f, tanh g,
    sigmoid o), ``tc`` (tanh c'), ``sig`` [R, 3] (the head's sigmoids),
    ``rel`` [R, 5], ``pred`` [R, 2]; ``chain``: (positions [S, A, 2],
    validity [S, A]) whose primary lane takes the step's, or None."""
    hidden = c.shape[1]
    x_width = xh.shape[1] - hidden - 1
    h = xh[:, x_width:x_width + hidden]
    i, f, g, o = gates.chunk(4, dim=1)
    si, sf, tg, so = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
    c_new = sf * c + si * tg
    t = torch.tanh(c_new)
    h_new = so * t
    m = mask[:, None]
    xh_next[:, x_width:x_width + hidden] = torch.where(m, h_new, h)
    xh_next[:, -1] = 1.0
    c_next.copy_(torch.where(m, c_new, c))
    act.copy_(torch.cat([si, sf, tg, so], dim=1))
    tc.copy_(t)
    raw = h_new @ w_h2n + b_h2n
    s = torch.sigmoid(raw[:, 2:5])
    sig.copy_(s)
    normal = torch.cat([raw[:, :2], 0.01 + 0.2 * s[:, :2], 0.7 * s[:, 2:]], dim=1) * m
    rel.copy_(normal)
    pred.copy_((obs2 + normal[:, :2]) * m)
    if chain is not None:
        chain_xy, chain_mask = chain
        agents = chain_xy.shape[1]
        chain_xy[:, 0] = pred.view(-1, agents, 2)[:, 0]
        chain_mask[:, 0] = mask.view(-1, agents)[:, 0]


def fused_train_cell_backward_plain(d_rel, d_pred, mask, sig, act, tc, c, w_h2n, dh_gemm, dh,
                                    dc, dg, draw) -> None:
    """One step of the backward: ``dg`` [R, 4H] (the gates' gradient) and
    ``draw`` [R, 5] (the raw head's) from the step's ``d_rel`` [R, 5],
    ``d_pred`` [R, 2] (None: zero) and the carried ``dh`` (+ ``dh_gemm``
    unless None) and ``dc``, which are updated in place for the step
    before."""
    m = mask[:, None]
    dn = d_rel.clone()
    if d_pred is not None:
        dn[:, :2] += d_pred * m
    dn = dn * m
    s = sig
    dr = torch.cat([dn[:, :2], dn[:, 2:4] * 0.2 * s[:, :2] * (1 - s[:, :2]),
                    dn[:, 4:] * 0.7 * s[:, 2:] * (1 - s[:, 2:])], dim=1)
    draw.copy_(dr)
    dh_in = dh if dh_gemm is None else dh + dh_gemm
    si, sf, tg, so = act.chunk(4, dim=1)
    dhn = (dh_in + dr @ w_h2n.t()) * m
    dcn = dc * m + dhn * so * (1 - tc * tc)
    dg.copy_(torch.cat([dcn * tg * si * (1 - si), dcn * c * sf * (1 - sf),
                        dcn * si * (1 - tg * tg), dhn * tc * so * (1 - so)], dim=1))
    dc.copy_(torch.where(m, dcn * sf, dc))
    dh.copy_(torch.where(m, torch.zeros_like(dh_in), dh_in))


def fused_train_in_backward_plain(dx, xh) -> None:
    """Both relu masks on the x part's gradient ``dx`` [N, E + P], in place:
    zero where the step's input ``xh[:, :E + P]`` is not positive (the two
    tag columns included)."""
    x = xh[:, :dx.shape[1]]
    dx.copy_(torch.where(x > 0, dx, torch.zeros_like(dx)))


def nll_and_grad(inputs: torch.Tensor, targets: torch.Tensor):
    """(values [...], their gradient with respect to ``inputs`` [..., 5]) of
    ``losses.prediction_loss``'s mixture NLL, -log(0.01 + 0.2 N(mu, 3) +
    0.79 N(mu, sigma, rho)), at ``inputs`` [..., 5] (mu1, mu2, s1, s2, rho)
    and ``targets`` [..., 2], the gradient written out by hand."""
    mu1, mu2, s1, s2, rho = inputs.unbind(-1)
    n1, n2 = targets[..., 0] - mu1, targets[..., 1] - mu2
    g_bg = torch.exp(-((n1 / 3.0) ** 2 + (n2 / 3.0) ** 2) / 2.0) / (2 * math.pi * 9.0)
    a, b, q = n1 / s1, n2 / s2, 1 - rho ** 2
    z = a * a + b * b - 2 * rho * n1 * n2 / (s1 * s2)
    g = torch.exp(-z / (2 * q)) / (2 * math.pi * s1 * s2 * torch.sqrt(q))
    density = 0.01 + 0.2 * g_bg + 0.79 * g
    c_bg, c = -0.2 * g_bg / density, -0.79 * g / density  # d value / d log of each density
    grad = torch.stack([
        c_bg * n1 / 9.0 + c * (a - rho * b) / (s1 * q),
        c_bg * n2 / 9.0 + c * (b - rho * a) / (s2 * q),
        c * (a * (a - rho * b) / q - 1) / s1,
        c * (b * (b - rho * a) / q - 1) / s2,
        c * (a * b / q - rho * z / (q * q) + rho / q)], dim=-1)
    return -torch.log(density), grad


def fused_train_loss_plain(rel, targets, scene_mask, loss, count, dvals) -> None:
    """``losses.prediction_loss`` of the primaries' last P normals of
    ``rel`` [T', S, A, 5] against ``targets`` [P, S, 2] with ``scene_mask``
    [S]: the loss into ``loss`` [], the masked entries' count into ``count``
    [], each entry's gradient of its value into ``dvals`` [P, S, 5] (zero in a
    masked scene)."""
    p = targets.shape[0]
    m = scene_mask[None, :, None].expand(p, -1, 1)
    unit = torch.zeros(5, dtype=rel.dtype, device=rel.device)
    unit[2:4] = 1.0
    inputs = torch.where(m, rel[-p:, :, 0], unit)
    values, grad = nll_and_grad(inputs, torch.where(m, targets, torch.zeros_like(targets)))
    dvals.copy_(torch.where(m, grad, torch.zeros_like(grad)))
    n = m.sum().to(rel.dtype)
    count.copy_(n)
    loss.copy_((values * m[..., 0]).sum() / torch.clamp(n, min=1))


def fused_train_loss_backward_plain(d_loss, dvals, count, d_rel) -> None:
    """The loss's gradient with respect to ``rel``: ``d_loss`` [] / max(count,
    1) times ``dvals`` at the primaries' last P steps of ``d_rel`` [T', S, A,
    5], zero elsewhere."""
    p = dvals.shape[0]
    d_rel.zero_()
    d_rel[-p:, :, 0] = dvals * (d_loss / torch.clamp(count, min=1))


# ------------------------------------------------------------------ checks
def _check(name, x, shape, dtype, device, contiguous=True):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(x.shape)}")
    if contiguous and not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_rows(rows: int) -> None:
    if rows < 1:
        raise ValueError(f"the kernels take one row or more, got {rows}")


def _kernel_device(x: torch.Tensor) -> bool:
    """True for a tensor on the card (launch the kernel), False on the CPU
    (run the plain version); raises on any other device, and on the card
    unless ``x`` is float32."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"the kernels take float32, got {x.dtype}")
    return True


def _launch(entry: str, *args):
    from . import build

    with torch.cuda.device(args[0].device if isinstance(args[0], torch.Tensor) else None):
        ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else (0 if a is None else a)
                for a in args]
        status = getattr(build.load_library(), entry)(
            *ptrs, torch.cuda.current_stream().cuda_stream)
    build.check(status, entry)


# ------------------------------------------------------------------ wrappers
def fused_train_in(obs1, obs2, present1, present2, pre, w_emb, b_emb, b_grid, xh, v4,
                   mask) -> None:
    """Step 3 of the rollout (``fused_train_in_plain``): positions [S, A, 2],
    presence [S, A] bool, ``pre`` [R, P], ``w_emb`` [2, E - 2], ``b_emb``,
    ``b_grid``; writes ``xh`` [R, ld] (ld > E + P), ``v4`` [R, 3], ``mask``
    [R] bool.  The kernel on the card, the plain version on the CPU."""
    s, a = obs2.shape[:2]
    rows, lin, pool = s * a, w_emb.shape[1], pre.shape[1]
    dev, dt = obs2.device, w_emb.dtype
    _check_rows(rows)
    for name, x, shape, dtype in (
            ("obs1", obs1, (s, a, 2), dt), ("obs2", obs2, (s, a, 2), dt),
            ("present1", present1, (s, a), torch.bool), ("present2", present2, (s, a), torch.bool),
            ("pre", pre, (rows, pool), dt), ("w_emb", w_emb, (2, lin), dt),
            ("b_emb", b_emb, (lin,), dt), ("b_grid", b_grid, (pool,), dt),
            ("xh", xh, (rows, xh.shape[1]), dt), ("v4", v4, (rows, 3), dt),
            ("mask", mask, (rows,), torch.bool)):
        _check(name, x, shape, dtype, dev)
    if xh.shape[1] <= lin + 2 + pool:
        raise ValueError(f"xh's rows ({xh.shape[1]}) must be wider than x ({lin + 2 + pool})")
    if not _kernel_device(obs2):
        return fused_train_in_plain(obs1, obs2, present1, present2, pre, w_emb, b_emb, b_grid,
                                    xh, v4, mask)
    _launch("dlstm_train_in", obs1, obs2, present1, present2, pre, w_emb, b_emb, b_grid, xh, v4,
            mask, rows, lin, pool, xh.shape[1])
    fused_train_in.launches += 1


fused_train_in.launches = 0


def fused_train_cell(gates, xh, c, mask, obs2, w_h2n, b_h2n, xh_next, c_next, act, tc, sig,
                     rel, pred, chain: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                     ) -> None:
    """Step 5 of the rollout (``fused_train_cell_plain``): ``gates`` [R, 4H]
    (bias included), ``xh``/``xh_next`` [R, ld] (h at columns ld - H - 1 ..
    ld - 2), ``c``/``c_next``/``tc`` [R, H], ``mask`` [R] bool, ``obs2`` [R,
    2], ``w_h2n`` [H, 5], ``b_h2n`` [5], ``act`` [R, 4H], ``sig`` [R, 3],
    ``rel`` [R, 5], ``pred`` [R, 2], ``chain`` (positions [S, A, 2], validity
    [S, A] bool) or None.  The kernel on the card, the plain version on the
    CPU."""
    rows, hidden = c.shape
    ld = xh.shape[1]
    dev, dt = c.device, c.dtype
    _check_rows(rows)
    for name, x, shape, dtype in (
            ("gates", gates, (rows, 4 * hidden), dt), ("xh", xh, (rows, ld), dt),
            ("c", c, (rows, hidden), dt), ("mask", mask, (rows,), torch.bool),
            ("obs2", obs2, (rows, 2), dt), ("w_h2n", w_h2n, (hidden, 5), dt),
            ("b_h2n", b_h2n, (5,), dt), ("xh_next", xh_next, (rows, ld), dt),
            ("c_next", c_next, (rows, hidden), dt), ("act", act, (rows, 4 * hidden), dt),
            ("tc", tc, (rows, hidden), dt), ("sig", sig, (rows, 3), dt),
            ("rel", rel, (rows, 5), dt), ("pred", pred, (rows, 2), dt)):
        _check(name, x, shape, dtype, dev)
    if ld <= hidden + 1:
        raise ValueError(f"xh's rows ({ld}) must be wider than h and the ones column")
    agents = 1
    if chain is not None:
        agents = chain[0].shape[1]
        if rows % agents:
            raise ValueError(f"the chain's {agents} agents do not divide {rows} rows")
        _check("chain positions", chain[0], (rows // agents, agents, 2), dt, dev)
        _check("chain validity", chain[1], (rows // agents, agents), torch.bool, dev)
    if not _kernel_device(c):
        return fused_train_cell_plain(gates, xh, c, mask, obs2, w_h2n, b_h2n, xh_next, c_next,
                                      act, tc, sig, rel, pred, chain)
    chain_xy, chain_mask = chain if chain is not None else (None, None)
    _launch("dlstm_train_cell", gates, xh, c, mask, obs2, w_h2n, b_h2n, xh_next, c_next, act,
            tc, sig, rel, pred, chain_xy, chain_mask, rows, agents, hidden, ld)
    fused_train_cell.launches += 1


fused_train_cell.launches = 0


def fused_train_cell_backward(d_rel, d_pred, mask, sig, act, tc, c, w_h2n, dh_gemm, dh, dc, dg,
                              draw) -> None:
    """One step of the backward (``fused_train_cell_backward_plain``):
    ``d_rel`` [R, 5], ``d_pred`` [R, 2] or None, ``mask`` [R] bool, ``sig``
    [R, 3], ``act`` [R, 4H], ``tc``/``c`` [R, H], ``w_h2n`` [H, 5],
    ``dh_gemm`` [R, H] or None; updates ``dh`` and ``dc`` [R, H] in place,
    writes ``dg`` [R, 4H] and ``draw`` [R, 5].  The kernel on the card, the
    plain version on the CPU."""
    rows, hidden = c.shape
    dev, dt = c.device, c.dtype
    _check_rows(rows)
    for name, x, shape, dtype in (
            ("d_rel", d_rel, (rows, 5), dt), ("d_pred", d_pred, (rows, 2), dt),
            ("mask", mask, (rows,), torch.bool), ("sig", sig, (rows, 3), dt),
            ("act", act, (rows, 4 * hidden), dt), ("tc", tc, (rows, hidden), dt),
            ("c", c, (rows, hidden), dt), ("w_h2n", w_h2n, (hidden, 5), dt),
            ("dh_gemm", dh_gemm, (rows, hidden), dt), ("dh", dh, (rows, hidden), dt),
            ("dc", dc, (rows, hidden), dt), ("dg", dg, (rows, 4 * hidden), dt),
            ("draw", draw, (rows, 5), dt)):
        if x is not None or name not in ("d_pred", "dh_gemm"):
            _check(name, x, shape, dtype, dev)
    if not _kernel_device(c):
        return fused_train_cell_backward_plain(d_rel, d_pred, mask, sig, act, tc, c, w_h2n,
                                               dh_gemm, dh, dc, dg, draw)
    _launch("dlstm_train_cell_backward", d_rel, d_pred, mask, sig, act, tc, c, w_h2n, dh_gemm,
            dh, dc, dg, draw, rows, hidden)
    fused_train_cell_backward.launches += 1


fused_train_cell_backward.launches = 0


def fused_train_in_backward(dx, xh) -> None:
    """Both relu masks on ``dx`` [N, E + P] in place (``fused_train_in_backward_plain``),
    read from ``xh`` [N, ld].  The kernel on the card, the plain version on
    the CPU."""
    n, width = dx.shape
    _check_rows(n)
    _check("dx", dx, (n, width), dx.dtype, dx.device)
    _check("xh", xh, (n, xh.shape[1]), dx.dtype, dx.device)
    if xh.shape[1] < width:
        raise ValueError(f"xh's rows ({xh.shape[1]}) are narrower than dx's ({width})")
    if not _kernel_device(dx):
        return fused_train_in_backward_plain(dx, xh)
    _launch("dlstm_train_in_backward", dx, xh, n, width, xh.shape[1])
    fused_train_in_backward.launches += 1


fused_train_in_backward.launches = 0


def fused_train_loss(rel, targets, scene_mask, loss, count, dvals) -> None:
    """The mixture NLL of the primaries' last P steps
    (``fused_train_loss_plain``): ``rel`` [T', S, A, 5], ``targets`` [P, S,
    2], ``scene_mask`` [S] bool; writes ``loss`` [], ``count`` [] and
    ``dvals`` [P, S, 5].  The kernel on the card, the plain version on the
    CPU."""
    t_all, s, a = rel.shape[:3]
    p = targets.shape[0]
    dev, dt = rel.device, rel.dtype
    _check_rows(p * s)
    if not 1 <= p <= t_all:
        raise ValueError(f"the loss reads 1 to {t_all} steps, got {p}")
    for name, x, shape, dtype in (
            ("rel", rel, (t_all, s, a, 5), dt), ("targets", targets, (p, s, 2), dt),
            ("scene_mask", scene_mask, (s,), torch.bool), ("loss", loss, (), dt),
            ("count", count, (), dt), ("dvals", dvals, (p, s, 5), dt)):
        _check(name, x, shape, dtype, dev)
    if not _kernel_device(rel):
        return fused_train_loss_plain(rel, targets, scene_mask, loss, count, dvals)
    _launch("dlstm_train_loss", rel, targets, scene_mask, loss, count, dvals, t_all, p, s, a)
    fused_train_loss.launches += 1


fused_train_loss.launches = 0


def fused_train_loss_backward(d_loss, dvals, count, d_rel) -> None:
    """The loss's gradient with respect to ``rel``
    (``fused_train_loss_backward_plain``): ``d_loss`` [], ``dvals`` [P, S, 5],
    ``count`` []; writes ``d_rel`` [T', S, A, 5].  The kernel on the card,
    the plain version on the CPU."""
    t_all, s, a = d_rel.shape[:3]
    p = dvals.shape[0]
    dev, dt = d_rel.device, d_rel.dtype
    _check_rows(t_all * s * a)
    if not 1 <= p <= t_all:
        raise ValueError(f"the loss reads 1 to {t_all} steps, got {p}")
    for name, x, shape, dtype in (
            ("d_loss", d_loss, (), dt), ("dvals", dvals, (p, s, 5), dt), ("count", count, (), dt),
            ("d_rel", d_rel, (t_all, s, a, 5), dt)):
        _check(name, x, shape, dtype, dev)
    if not _kernel_device(d_rel):
        return fused_train_loss_backward_plain(d_loss, dvals, count, d_rel)
    _launch("dlstm_train_loss_backward", d_loss, dvals, count, d_rel, t_all, p, s, a)
    fused_train_loss_backward.launches += 1


fused_train_loss_backward.launches = 0

KERNELS = (fused_train_in, fused_train_cell, fused_train_cell_backward, fused_train_in_backward,
           fused_train_loss, fused_train_loss_backward)


# ---------------------------------------------------------------- Function
class FusedTrainRollout(torch.autograd.Function):
    """The teacher-forced rollout of a goal-free ``one_layer`` directional
    grid D-LSTM (module docstring).  Inputs: ``grid`` (positions and
    presence at t-1 and t -> the flat grid [S, A, G]), observed [T_obs, S,
    A, 2] and its mask, the teacher-forcing truth [n_dec, S, A, 2] and its
    mask, then the weights: ``w_emb`` [2, E - 2], ``b_emb``, ``w_grid`` [G,
    P], ``b_grid``, each cell's ``[W_ih; W_hh; b_ih + b_hh]`` [E + P + H +
    1, 4H] (encoder, decoder), ``w_h2n`` [H, 5], ``b_h2n``.  Outputs:
    rel_pred [T, S, A, 5], pred [T, S, A, 2], valid [T, S, A] bool, as
    ``LSTM.forward``'s."""

    @staticmethod
    def forward(ctx, grid: Callable, observed, observed_mask, truth, truth_mask, w_emb, b_emb,
                w_grid, b_grid, w_enc, w_dec, w_h2n, b_h2n):
        ctx.set_materialize_grads(False)
        t_obs, s, a = observed.shape[:3]
        te, n_dec = t_obs - 1, truth.shape[0]
        steps, rows = te + n_dec, s * a
        lin, pool, hidden = w_emb.shape[1], w_grid.shape[1], w_h2n.shape[0]
        x_width = lin + 2 + pool
        ld = x_width + hidden + 1
        kw = dict(device=observed.device, dtype=w_emb.dtype)
        xh = torch.empty((steps + 1, rows, ld), **kw)  # each step's [x | h | 1]
        xh[0, :, x_width:x_width + hidden].zero_()
        c = torch.empty((steps + 1, rows, hidden), **kw)
        c[0].zero_()
        act = torch.empty((steps, rows, 4 * hidden), **kw)
        tc = torch.empty((steps, rows, hidden), **kw)
        sig = torch.empty((steps, rows, 3), **kw)
        v4 = torch.empty((steps, rows, 3), **kw)
        rel = torch.empty((steps, s, a, 5), **kw)
        pred = torch.empty((steps, s, a, 2), **kw)
        valid = torch.empty((steps, s, a), dtype=torch.bool, device=observed.device)
        # the decoder's teacher-forcing chain: ground truth from the last
        # observed frame on, the primary's lane filled in by the cell kernel
        # of the step two before (the encoder's last two fill its first two)
        chain = torch.cat([observed[-1:], truth])
        chain_mask = torch.cat([observed_mask[-1:], truth_mask])
        # the encoder's grids read data only: their products with W_grid are
        # one product over the encoder's steps
        enc_frames = [(observed[g], observed[g + 1], observed_mask[g], observed_mask[g + 1])
                      for g in range(te)]
        grids = [torch.cat([grid(*frames).reshape(rows, -1) for frames in enc_frames])]
        enc_pre = grids[0] @ w_grid
        for g in range(steps):
            if g < te:
                frames, w_cell = enc_frames[g], w_enc
                pre = enc_pre[g * rows:(g + 1) * rows]
            else:
                k = g - te
                frames = (chain[k], chain[k + 1], chain_mask[k], chain_mask[k + 1])
                w_cell = w_dec
                grids.append(grid(*frames).reshape(rows, -1))
                pre = grids[-1] @ w_grid
            fused_train_in(*frames, pre, w_emb, b_emb, b_grid, xh[g], v4[g],
                           valid[g].view(rows))
            slot = g - te + 2
            fused_train_cell(xh[g] @ w_cell, xh[g], c[g], valid[g].view(rows),
                             frames[1].view(rows, 2), w_h2n, b_h2n, xh[g + 1], c[g + 1], act[g],
                             tc[g], sig[g], rel[g].view(rows, 5), pred[g].view(rows, 2),
                             (chain[slot], chain_mask[slot]) if 0 <= slot <= n_dec else None)
        ctx.mark_non_differentiable(valid)
        ctx.save_for_backward(w_enc, w_dec, w_h2n, valid)
        ctx.stacks = (xh, c, act, tc, sig, v4, grids)
        ctx.dims = (te, steps, rows, lin, x_width, hidden)
        return rel, pred, valid

    @staticmethod
    def backward(ctx, d_rel, d_pred, _d_valid):
        w_enc, w_dec, w_h2n, valid = ctx.saved_tensors
        xh, c, act, tc, sig, v4, grids = ctx.stacks
        te, steps, rows, lin, x_width, hidden = ctx.dims
        kw = dict(device=xh.device, dtype=xh.dtype)
        d_rel = (torch.zeros((steps, rows, 5), **kw) if d_rel is None
                 else d_rel.contiguous().view(steps, rows, 5))
        d_pred = None if d_pred is None else d_pred.contiguous().view(steps, rows, 2)
        dh, dc = torch.zeros((2, rows, hidden), **kw)
        dg = torch.empty((steps, rows, 4 * hidden), **kw)
        draw = torch.empty((steps, rows, 5), **kw)
        dh_gemm = None
        for g in reversed(range(steps)):
            fused_train_cell_backward(d_rel[g], None if d_pred is None else d_pred[g],
                                      valid[g].view(rows), sig[g], act[g], tc[g], c[g], w_h2n,
                                      dh_gemm, dh, dc, dg[g], draw[g])
            if g:
                w_cell = w_enc if g < te else w_dec
                dh_gemm = dg[g] @ w_cell[x_width:x_width + hidden].t()
        n, ld, gates = steps * rows, xh.shape[2], 4 * hidden
        dx = torch.empty((steps, rows, x_width), **kw)
        for cell, (lo, hi) in ((w_enc, (0, te)), (w_dec, (te, steps))):
            torch.mm(dg[lo:hi].view(-1, gates), cell[:x_width].t(),
                     out=dx[lo:hi].view(-1, x_width))
        dx = dx.view(n, x_width)
        xh_steps = xh[:steps].view(n, ld)
        fused_train_in_backward(dx, xh_steps)
        d_emb = v4.view(n, 3).t() @ dx[:, :lin]  # [3, E - 2]: W_emb's rows, then b_emb
        d_pool = dx[:, lin + 2:]
        d_w_grid = torch.cat(grids).t() @ d_pool
        d_w_enc = xh_steps[:te * rows].t() @ dg[:te].view(-1, gates)
        d_w_dec = xh_steps[te * rows:].t() @ dg[te:].view(-1, gates)
        d_h2n = xh[1:].view(n, ld)[:, x_width:].t() @ draw.view(n, 5)  # [H + 1, 5]
        return (None, None, None, None, None, d_emb[:2], d_emb[2], d_w_grid, d_pool.sum(0),
                d_w_enc, d_w_dec, d_h2n[:hidden], d_h2n[hidden])


def cell_weights(cell: dict) -> torch.Tensor:
    """``[W_ih; W_hh; b_ih + b_hh]`` of one LSTM cell's params, the gate
    product's weights with the bias as the ones column's row."""
    return torch.cat([cell["w_ih"], cell["w_hh"], (cell["b_ih"] + cell["b_hh"])[None]])


def fused_train_rollout(params: dict, observed, observed_mask, truth, truth_mask,
                        grid: Callable):
    """``FusedTrainRollout`` of an LSTM's ``params`` (the JAX layout) on the
    placed inputs; ``grid(obs1, obs2, present1, present2)`` makes a step's
    flat grid.  Returns (rel_pred, pred, valid)."""
    emb = params["input_embedding"]["linear"]
    layer = params["pool"]["embedding"][0]
    h2n = params["hidden2normal"]["linear"]
    return FusedTrainRollout.apply(
        grid, observed, observed_mask, truth, truth_mask, emb["w"], emb["b"], layer["w"],
        layer["b"], cell_weights(params["encoder"]), cell_weights(params["decoder"]), h2n["w"],
        h2n["b"])


class FusedPredictionLoss(torch.autograd.Function):
    """``losses.prediction_loss(rel[-P:, :, 0], targets, scene_mask)`` as one
    kernel forward (the values, their gradients and the masked mean, in one
    block) and one backward (the gradient of the whole ``rel``, zero off the
    primaries' last P steps, so that no slice's backward runs)."""

    @staticmethod
    def forward(ctx, rel, targets, scene_mask):
        p, s = targets.shape[:2]
        loss, count = rel.new_empty(()), rel.new_empty(())
        dvals = rel.new_empty((p, s, 5))
        fused_train_loss(rel, targets, scene_mask, loss, count, dvals)
        ctx.saved = (dvals, count)
        ctx.shape = rel.shape
        return loss

    @staticmethod
    def backward(ctx, d_loss):
        dvals, count = ctx.saved
        d_rel = dvals.new_empty(ctx.shape)
        fused_train_loss_backward(d_loss.contiguous(), dvals, count, d_rel)
        return d_rel, None, None


def prediction_loss(rel, targets, scene_mask):
    """``losses.prediction_loss`` of the primaries' last ``targets.shape[0]``
    normals of a rollout's ``rel`` [T', S, A, 5] (``FusedPredictionLoss``);
    ``targets`` in another float dtype are cast to ``rel``'s (exact where
    they are narrower, as the plain loss promotes them)."""
    return FusedPredictionLoss.apply(rel, targets.to(rel.dtype).contiguous(),
                                     scene_mask.contiguous())
