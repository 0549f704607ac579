"""serve.sepformer.masked_chunk_share: the share of the chunks that
SepFormer's intra stacks ran in the traced window that lie past their row's
own segmentation (the bucket's padding, masked out of the inter attention and
zeroed): Σ(chunks - valid_chunks) / Σ chunks over the port's
``sepformer.intra`` spans inside ``serve.job`` (bm/port_spans.py).  None
against a port without the span."""

from bm import port_spans

READS = ("trace",)


def read(r):
    ps = port_spans.read(r)
    if ps is None:
        return None
    stacks = ps.under("serve.job", "sepformer.intra")
    if not stacks:
        return None
    chunks = sum(x.attrs["chunks"] for x in stacks)
    return 100.0 * (chunks - sum(x.attrs["valid_chunks"] for x in stacks)) / chunks
