from ripor_tpu_torch.trie.build import DocIdTrie, build_trie
from ripor_tpu_torch.trie.succinct import (
    TrieTables,
    dummy_tables,
    succinct_tables,
    tables_memory_bytes,
    tables_to_torch,
)

__all__ = ["DocIdTrie", "build_trie", "TrieTables", "succinct_tables",
           "dummy_tables", "tables_memory_bytes", "tables_to_torch"]
