"""Which tiles of the compact encode and the string gather take the long-row
route, in torch: the producers' test in ``csrc/compact_encode.cu`` and
``csrc/string_gather.cu``, written again from the plan, the inputs and
their addresses.  The kernels mark the tiles that went long where asked
(``kernels._launch_compact_encode`` / ``_launch_string_gather`` with
``long_tiles``); the tests hold this copy against those marks on the card
and against the CPU replays.  No JAX here.
"""

import torch


def _chunk_bytes(addr: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """The bytes the bulk copy of ``length`` bytes at each ``addr`` moves,
    its aligned 16-byte chunks (``bulk_copy.cuh``'s ``stage_chunk_bytes``),
    0 where there is nothing to copy (int64)."""
    moved = ((addr + length + 15) // 16 - addr // 16) * 16
    return torch.where(length > 0, moved, torch.zeros_like(moved))


def _tile_sums(v: torch.Tensor, rows: int) -> torch.Tensor:
    """Sums of ``v`` over consecutive tiles of ``rows``."""
    pad = -v.shape[0] % rows
    return torch.cat([v, v.new_zeros(pad)]).view(-1, rows).sum(1)


def encode_long_tiles(plan, fixed: torch.Tensor, row_offsets: torch.Tensor,
                      strings) -> torch.Tensor:
    """bool ``[tiles]``: which tiles of the compact encode's batch take the
    long-row route by ``plan``: the chunks of the tile's chars pass
    ``chars_bytes``, or its output (from the 8-byte residue of its start in
    the 16-byte aligned output) ``image_bytes``."""
    n = fixed.shape[0]
    r0 = torch.arange(0, n, plan.tile_rows, device=fixed.device)
    r1 = (r0 + plan.tile_rows).clamp(max=n)
    ro = row_offsets.to(torch.int64)
    chars = torch.zeros_like(r0)
    for data, offsets, lo in strings:
        o = offsets.to(torch.int64)
        chars += _chunk_bytes(data.data_ptr() + o[r0] - lo, o[r1] - o[r0])
    image = ro[r0] % 16 + ro[r1] - ro[r0]
    return (chars > plan.chars_bytes) | (image > plan.image_bytes)


def _row_spans(pairs):
    """Each row's span over the string columns' ``(str_off, str_len,
    out_off)``: its least string offset and its bytes up to its greatest
    string end, over the strings with chars (0 bytes: none), int64."""
    offs = torch.stack([p[0] for p in pairs]).to(torch.int64)
    oo = torch.stack([p[2] for p in pairs]).to(torch.int64)
    lens = oo[:, 1:] - oo[:, :-1]
    some = lens > 0
    lo = torch.where(some, offs, torch.full_like(offs, 1 << 62)).min(0)[0]
    hi = torch.where(some, offs + lens, torch.zeros_like(offs)).max(0)[0]
    return lo, (hi - lo).clamp(min=0)


def gather_long_tiles(plan, blob: torch.Tensor, row_offsets: torch.Tensor,
                      pairs) -> torch.Tensor:
    """bool ``[tiles]``: which tiles of the string gather's batch take the
    long-row route by ``plan``: the chunks of its rows' spans pass
    ``chars_bytes``, or its columns' parts of the output (each from its
    offset in a 16-byte word of the 16-byte aligned outputs)
    ``image_bytes``."""
    n = row_offsets.shape[0] - 1
    ro = row_offsets.to(torch.int64)
    r0 = torch.arange(0, n, plan.tile_rows, device=blob.device)
    r1 = (r0 + plan.tile_rows).clamp(max=n)
    lo, span = _row_spans(pairs)
    start = blob.data_ptr() + ro[:-1] + torch.where(span > 0, lo, 0)
    need = _tile_sums(_chunk_bytes(start, span), plan.tile_rows)
    image = torch.zeros_like(r0)
    for _, _, out_off in pairs:
        oo = out_off.to(torch.int64)
        part = oo[r1] - oo[r0]
        image += torch.where(part > 0, (oo[r0] % 16 + part + 15) // 16 * 16,
                             torch.zeros_like(part))
    return (need > plan.chars_bytes) | (image > plan.image_bytes)
