"""METIS graph format (text) reader/writer (counterpart of
``kaminpar_tpu/io/metis.py``; byte-identical files).

Reference: ``kaminpar-io/metis_parser.cc:29-50`` (mmap tokenizer).  Format:
header line ``n m [fmt]``; line ``i`` (1-based) lists node ``i``'s neighbors
(1-indexed); fmt 1 = edge weights, 10 = node weights, 11 = both; ``%``-lines
are comments.  Each undirected edge appears twice.

Files are read by the native C++ parser (``io/native.py``).  The NumPy
parser below, the plain version, runs where ``KAMINPAR_TPU_NO_NATIVE=1``
asks for it: one pass classifies bytes into token starts and line ids,
digit-mask arithmetic yields the token values, and degree/offset
arithmetic assigns tokens to nodes.  Both reject the same malformed inputs
with the same exception types.

The graph comes back in host memory (CPU tensors); the facade places it on
its device.  The port holds ids and weights in int32 whatever
``use_64bit`` says: a file beyond that range raises ``ValueError``.
"""

from __future__ import annotations

import numpy as np

from ..graph.csr import CSRGraph, from_numpy_csr
from ..partitioning.kway import graph_to_host
from ..resilience.errors import GraphValidationError
from ..utils.logger import Logger
from . import native


def _tokenize(data: bytes):
    """Returns (values, line_of_token) for whitespace-separated non-negative
    integers, with %-comment lines removed.  Fully vectorized: token values
    are evaluated with digit-mask arithmetic on the byte buffer (no Python
    string objects), exact below 2**53 via float64 bincount accumulation."""
    if b"%" in data:
        data = b"\n".join(
            ln for ln in data.split(b"\n") if not ln.lstrip().startswith(b"%")
        )
    buf = np.frombuffer(data, dtype=np.uint8)
    if buf.size == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    is_nl = buf == ord("\n")
    is_ws = is_nl | (buf == ord(" ")) | (buf == ord("\t")) | (buf == ord("\r"))
    is_digit = (buf >= ord("0")) & (buf <= ord("9"))
    if np.any(~is_ws & ~is_digit):
        raise ValueError("METIS tokens must be non-negative integers")
    prev_ws = np.concatenate([[True], is_ws[:-1]])
    starts = ~is_ws & prev_ws
    token_pos = np.nonzero(starts)[0]
    T = token_pos.size
    if T == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    # per-token line id and per-digit token id via searchsorted on positions
    # (keeps temporaries proportional to token/digit counts, not full-buffer
    # int64 arrays; the streaming mmap variant is the native-parser's job)
    nl_pos = np.nonzero(is_nl)[0]
    line_of_token = np.searchsorted(nl_pos, token_pos)
    dig_pos = np.nonzero(is_digit)[0]
    tid_dig = np.searchsorted(token_pos, dig_pos, side="right") - 1
    ws_pos = np.nonzero(is_ws)[0]
    nxt = np.searchsorted(ws_pos, token_pos)
    tok_end = np.where(nxt < ws_pos.size, ws_pos[nxt], buf.size)  # exclusive

    # value[t] = sum over its digit chars of digit * 10**(chars to token end)
    exp = tok_end[tid_dig] - 1 - dig_pos
    contrib = (buf[dig_pos] - ord("0")) * np.power(10.0, exp)
    values = np.bincount(tid_dig, weights=contrib, minlength=T)
    if np.any(values >= 2**53):
        raise ValueError("integer token exceeds exact float64 range")
    return values.astype(np.int64), line_of_token


def read_metis(path: str, *, use_64bit: bool = False) -> CSRGraph:
    if native.native_requested():
        graph = _checked_csr(path, *native.parse_metis_native(path))
        Logger.log(f"{path}: read by the native METIS parser")
    else:
        graph = _read_metis_numpy(path)
        Logger.log(f"{path}: read by the NumPy METIS parser ({native.NO_NATIVE_ENV}=1)")
    return graph


def _read_metis_numpy(path: str) -> CSRGraph:
    with open(path, "rb") as f:
        data = f.read()
    values, line = _tokenize(data)
    if values.size == 0:
        raise ValueError(f"{path}: empty METIS file")

    header_mask = line == line[0]
    header = values[header_mask]
    # Same hardening as the native parser (parse results must not depend on
    # which parser ran): a one-token header errors, and header claims are
    # sanity-bounded by the file size before any allocation.
    if header.size < 2:
        raise ValueError(f"{path}: malformed header")
    n, m_undirected = int(header[0]), int(header[1])
    if n > len(data) + 1 or 2 * m_undirected > len(data):
        raise ValueError(f"{path}: malformed header")
    fmt = int(header[2]) if header.size > 2 else 0
    has_ew = fmt % 10 == 1
    has_nw = (fmt // 10) % 10 == 1

    body_vals = values[~header_mask]
    body_line = line[~header_mask]
    if n == 0:
        return from_numpy_csr(np.zeros(1), np.zeros(0))

    # node index per token: lines after the header map to nodes 0..n-1; blank
    # lines shift ids, so renumber via the distinct line ids present is wrong
    # (a blank line IS a degree-0 node).  METIS semantics: node i is the
    # (i+1)-th line, blank or not.
    first_body_line = line[0] + 1
    node_of_token = body_line - first_body_line
    if body_vals.size and (node_of_token.max() >= n):
        raise ValueError(f"{path}: more adjacency lines than nodes")

    tokens_per_node = np.bincount(node_of_token, minlength=n)
    off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(tokens_per_node, out=off[1:])

    node_w = None
    if has_nw:
        node_w = np.ones(n, dtype=np.int64)
        has_any = tokens_per_node > 0
        node_w[has_any] = body_vals[off[:-1][has_any]]

    # adjacency tokens: per node, skip the node-weight token, then neighbors
    # (interleaved with edge weights when has_ew)
    tok_idx = np.arange(body_vals.size)
    pos_in_node = tok_idx - off[node_of_token]
    if has_nw:
        pos_in_node -= 1
    valid = pos_in_node >= 0
    if has_ew:
        adj_mask = valid & (pos_in_node % 2 == 0)
        w_mask = valid & (pos_in_node % 2 == 1)
        edge_w = body_vals[w_mask]
    else:
        adj_mask = valid
        edge_w = None
    col_idx = body_vals[adj_mask] - 1  # 1-indexed on disk
    deg = np.bincount(node_of_token[adj_mask], minlength=n)
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=row_ptr[1:])

    if col_idx.size != 2 * m_undirected:
        raise ValueError(
            f"{path}: header claims {m_undirected} edges, found {col_idx.size} directed"
        )
    if col_idx.size and (col_idx.min() < 0 or col_idx.max() >= n):
        raise ValueError(f"{path}: neighbor id out of range")
    return _checked_csr(path, row_ptr, col_idx, node_w, edge_w)


def _checked_csr(path: str, row_ptr, col_idx, node_w, edge_w) -> CSRGraph:
    """The graph of a parsed file, through the input guard; a file the
    guard rejects is a malformed file, a plain ``ValueError`` as the JAX
    package's readers raise (the typed ``GraphValidationError`` is the
    facade's)."""
    try:
        return from_numpy_csr(row_ptr, col_idx, node_w, edge_w, validate_input=True)
    except GraphValidationError as exc:
        raise ValueError(f"{path}: {exc}") from None


def write_metis(graph: CSRGraph, path: str) -> None:
    """Vectorized: assemble one flat token array (optional per-node weight,
    then neighbors interleaved with edge weights), then one flat separator
    array whose entries carry the newline run preceding each token — blank
    lines for degree-0 nodes fall out of the per-token line-gap count."""
    rp, col, nw, ew = graph_to_host(graph)
    col = col + 1
    has_nw = bool(np.any(nw != 1))
    has_ew = bool(np.any(ew != 1))
    fmt = (10 if has_nw else 0) + (1 if has_ew else 0)
    n, m = graph.n, graph.m
    per_edge = 2 if has_ew else 1

    deg = np.diff(rp)
    tok_off = int(has_nw) * np.arange(n) + rp[:-1] * per_edge  # tokens before row
    T = int(has_nw) * n + m * per_edge
    vals = np.zeros(T, dtype=np.int64)
    row_of = np.zeros(T, dtype=np.int64)
    if has_nw:
        vals[tok_off] = nw
        row_of[tok_off] = np.arange(n)
    eu = np.repeat(np.arange(n), deg)
    slot = np.arange(m) - rp[eu]
    pos_v = tok_off[eu] + int(has_nw) + slot * per_edge
    vals[pos_v] = col
    row_of[pos_v] = eu
    if has_ew:
        vals[pos_v + 1] = ew
        row_of[pos_v + 1] = eu

    header = f"{n} {m // 2}" + (f" {fmt:03d}" if fmt else "")
    if T == 0:
        body = "\n" * (n + 1)  # header newline + one blank line per node
    else:
        gap = np.diff(row_of, prepend=-1)
        # separator before each token: gap newlines (enters a new line) or a
        # single space (same line)
        uniq = np.unique(gap)
        sep = np.empty(T, dtype=object)
        for g in uniq:
            sep[gap == g] = " " if g == 0 else "\n" * int(g)
        parts = np.char.add(sep.astype("U"), vals.astype("U20"))
        body = "".join(parts.tolist()) + "\n" * (n - int(row_of[-1]))
    with open(path, "w") as f:
        f.write(header + body)
