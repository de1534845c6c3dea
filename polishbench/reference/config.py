"""Polishing configuration.

Mirrors the reference CLI knobs (reference: src/utils/option.rs:15-36, defaults at
option.rs:267-292) as a dataclass. The engine's shape knobs are accepted so
that a configuration's overrides apply alike to the polisher and to the
reference, which does not read them.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass
class PolishConfig:
    # ----- reference-parity knobs (option.rs defaults) -----
    min_kmer_count: int = 5          # -k: drop yak k-mers with count < this... (kept if >= )
    iter_count: int = 2              # -i: phasing iterations (last one emits consensus)
    min_read_len: int = 1000         # -l: filter reads with length <= INT
    min_ctg_len: int = 1_000_000     # -L: contigs shorter than this pass through unpolished
    max_indel_len: int = 20          # -n: ignore indel errors with length > INT
    use_supplementary: bool = False  # -s
    use_secondary: bool = False      # -S
    use_all_reads: bool = False      # -r: keep reads phased against the reference haplotype
    min_map_qual: int = 1            # -q: filter alignments with mapq <= INT
    min_map_len: int = 500           # -a int part
    min_map_fra: float = 0.5         # -a fractional part
    max_clip_len: int = 100          # -c: clip filter threshold
    model: str = "ref"               # -m: phasing model, "ref" or "len"
    uppercase: bool = False          # -u
    out_pos: bool = False            # --out_pos
    min_base_cov: int = 1            # parsed but unused by the reference engine

    # constants baked into the reference engine (main.rs:30, main.rs:1565-1566,
    # main.rs:1798, main.rs:543)
    lqseq_max_can_count: int = 60    # max candidate alleles per LQ interval
    hq_min_qv: int = 95              # columns with qv < this open an LQ region
    lq_min_length: int = 2
    trim_len: int = 8                # alignments trimmed to start/end with 8 matches
    clip_margin: int = 50            # clip-filter covered-range margin
    short_ref_len: int = 500_000     # clipped alns on contigs < this are dropped

    # ----- TPU engine shape knobs (no reference equivalent) -----
    window_len: int = 1024           # columns per device window
    max_kmers_per_col: int = 48      # K: candidate 3-mer slots per MSA column
    threads: int = 1                 # host worker threads (-t; CLI default)

    def merged_min_map_len(self, read_len: int) -> int:
        """max(min_map_len, min_map_fra*read_len) — reference main.rs:1764-1768."""
        return max(self.min_map_len, int(read_len * self.min_map_fra))


def parse_min_map_len(value: float) -> Tuple[int, float]:
    """Split the -a INT.FLOAT knob: integer part is min_map_len, fractional part is
    min_map_fra (reference option.rs:258-259; default 500.5 -> (500, 0.5))."""
    return int(value), value - int(value)
