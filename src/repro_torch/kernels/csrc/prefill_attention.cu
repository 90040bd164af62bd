// Chunked-prefill GQA flash attention over a dense KV-major cache or a page
// pool, with the abort/progress protocol. Replaces
// src/repro/kernels/prefill_attention.py::prefill_attention and
// ::prefill_attention_paged (see attention_core.cuh for the design).
// A prefill block holds 16 of the chunk's Sq * G query rows, so each K/V
// tile it loads serves 16 rows; a block stops at the last key its own rows
// may see (causal), and rows at or past the abort cap see no key.
#include "attention_core.cuh"

SGDRC_ATTENTION_ENTRY(sgdrc_prefill_attention, 16)
