"""One lookup shard as an OS process (the counterpart of
``dlrm_flexflow_tpu.serve.shard_server``)::

    python -m dlrm_flexflow_tpu_torch.serve.shard_server \\
        --cache-dir /ckpt/cache --nshards 4 --slot 2 --port 0

Boots slot ``--slot`` of an ``--nshards``-way tier from a seeded warm
cache (``EmbeddingShardSet.seed_shard_cache`` wrote the row blocks and
the tier-geometry sidecar, in the JAX package's layout, so either
package's cache boots either package's shard) and serves the wire
protocol until it is killed. ``--port 0`` takes a port the system
chooses; the ``SHARD_SERVER_OK slot=S port=P version=V`` line on
stdout says which, so a spawner can read it.

A shard holds host rows only: the process creates no CUDA context.
``kill -9`` of it is a real shard outage: the tier's circuit breaker
ejects the slot, answers degrade (flagged), and replace-dead boots an
in-process shard from the same cache.
"""

from __future__ import annotations

import argparse


def build_shard(cache_dir: str, nshards: int, slot: int):
    """The boot path: warm-cache blocks and the geometry sidecar -> a
    live :class:`~.shardtier.EmbeddingShard`."""
    from ..utils.warmcache import ShardCache
    from .shardtier import EmbeddingShard

    cache = ShardCache(cache_dir)
    meta = cache.get_meta(nshards)
    if meta is None:
        raise SystemExit(
            f"shard_server: no tier meta for {nshards} shard(s) in "
            f"{cache_dir!r} ({cache.last_reject or 'missing'}) — seed "
            f"it with EmbeddingShardSet.seed_shard_cache")
    cache.fingerprint = str(meta.get("fingerprint", ""))
    got = cache.get(nshards, slot)
    if got is None:
        raise SystemExit(
            f"shard_server: no cached blocks for slot {slot} of "
            f"{nshards} in {cache_dir!r} "
            f"({cache.last_reject or 'missing'})")
    blocks, version, chain_crc = got
    ranges = {op: tuple(r[slot]) for op, r in meta["ranges"].items()}
    domains = meta.get("domains") or [""] * nshards
    return EmbeddingShard(
        slot, slot, blocks, ranges, version=version,
        chain_crc=chain_crc, domain=str(domains[slot]),
        quant={str(k): str(v)
               for k, v in (meta.get("quant") or {}).items()})


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="serve one embedding lookup shard over the wire "
                    "protocol (boots from a seeded shard warm cache)")
    ap.add_argument("--cache-dir", required=True,
                    help="seeded ShardCache directory "
                         "(EmbeddingShardSet.seed_shard_cache)")
    ap.add_argument("--nshards", type=int, required=True,
                    help="total shard count of the tier")
    ap.add_argument("--slot", type=int, required=True,
                    help="which row-range slot this process owns")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="listen port; 0 = chosen by the system (printed "
                         "on the SHARD_SERVER_OK line)")
    args = ap.parse_args(argv)
    if not 0 <= args.slot < args.nshards:
        ap.error(f"--slot {args.slot} outside [0, {args.nshards})")

    shard = build_shard(args.cache_dir, args.nshards, args.slot)
    server = shard.serve(host=args.host, port=args.port)
    print(f"SHARD_SERVER_OK slot={args.slot} "
          f"port={server.address[1]} version={shard.version}",
          flush=True)
    try:
        server.serve_forever()   # start() is idempotent; blocks here
    except KeyboardInterrupt:
        pass
    finally:
        server.close()


if __name__ == "__main__":
    main()
