"""The data-prep and evaluation tools, one module per script of the
repository's tools/ directory and under the same name:

    python -m nextpolish2_tpu_torch.tools.kmer_count   reads -> .yak
    python -m nextpolish2_tpu_torch.tools.align        HiFi reads -> sorted BAM
    python -m nextpolish2_tpu_torch.tools.qv           assembly QV (on the card)
    python -m nextpolish2_tpu_torch.tools.make_fixture      aligned fixture
    python -m nextpolish2_tpu_torch.tools.make_big_fixture  chromosome fixture
    python -m nextpolish2_tpu_torch.tools.check_against_truth
    python -m nextpolish2_tpu_torch.tools.merge_shards
    python -m nextpolish2_tpu_torch.tools.remove_low_depth
    python -m nextpolish2_tpu_torch.tools.phasing_debug
    python -m nextpolish2_tpu_torch.tools.louvain_check
    python -m nextpolish2_tpu_torch.tools.switch_eval

Each module's main(argv) is its entry point.
"""
