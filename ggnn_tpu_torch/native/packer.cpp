// Native batch-assembly kernels for the host-side data pipeline of
// ggnn_tpu_torch: a copy of ggnn_tpu/native/packer.cpp, so that the port
// packs every batch bit for bit as the JAX package's native packer does.
//
// The reference's feed-dict assembly (chem_tensorflow_dense.py:164-228,
// chem_tensorflow_sparse.py:278-350) loops over graphs in Python. These
// functions do the per-edge and per-node scatter work in C; Python keeps
// the orchestration (bucketing, shuffling, label semantics).
//
// Host code, compiled by g++ into a plain C-ABI shared library (no
// pybind11, no CUDA); ggnn_tpu_torch/native/__init__.py holds the build
// rule and the ctypes bindings.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Fill a bucketed dense batch: adjacency [B,T,V,V] (A[b,t,dst,src]=1,
// tied-bkwd in the same slice or at t+bwd_offset), node features
// [B,V,H] (annotations in the first A columns, zero-padded to H), node
// mask [B,V]. Outputs must be zero-initialised by the caller.
void pack_dense_batch(
    const int32_t* edges,        // [E_tot, 3] (src, 1-based type, dst)
    const int64_t* edge_offsets, // [G+1] per-corpus-graph edge ranges
    const float* feats,          // [N_tot, A]
    const int64_t* node_offsets, // [G+1]
    const int32_t* graph_ids,    // [b_real] corpus graph ids this batch
    int32_t b_real,
    int32_t num_edge_types,
    int32_t v,
    int32_t annotation_size,
    int32_t hidden_size,
    int32_t bwd_offset,          // 0 when tied, num_fwd_types otherwise
    float* init_out,             // [B, V, H]
    float* adj_out,              // [B, T, V, V]
    float* mask_out) {           // [B, V]
  const int64_t vv = (int64_t)v * v;
  const int64_t adj_stride = (int64_t)num_edge_types * vv;
  for (int32_t b = 0; b < b_real; ++b) {
    const int32_t g = graph_ids[b];
    float* adj = adj_out + (int64_t)b * adj_stride;
    for (int64_t e = edge_offsets[g]; e < edge_offsets[g + 1]; ++e) {
      const int32_t src = edges[e * 3 + 0];
      const int32_t typ = edges[e * 3 + 1] - 1;  // 1-based in JSON
      const int32_t dst = edges[e * 3 + 2];
      adj[(int64_t)typ * vv + (int64_t)dst * v + src] = 1.0f;
      adj[(int64_t)(typ + bwd_offset) * vv + (int64_t)src * v + dst] = 1.0f;
    }
    const int64_t n0 = node_offsets[g];
    const int32_t n = (int32_t)(node_offsets[g + 1] - n0);
    float* init = init_out + (int64_t)b * v * hidden_size;
    float* mask = mask_out + (int64_t)b * v;
    for (int32_t i = 0; i < n; ++i) {
      std::memcpy(init + (int64_t)i * hidden_size,
                  feats + (n0 + i) * annotation_size,
                  sizeof(float) * annotation_size);
      mask[i] = 1.0f;
    }
  }
}

// Fill a bucketed GCN dense batch (the gcn_blocked variant): per graph,
// adjacency = D^{-1/2}(sym(A)+I)D^{-1/2} over its n nodes, computed in
// double precision with the same association order as the numpy
// pipeline (packing._normalized_dense_adjacency: row sums of the
// integer-valued symmetrized+self-looped matrix are order-exact in
// double; each output entry is fl(fl(d_i*a)*d_j)) so eval batches are
// bit-identical to the python packer. Edge types are discarded
// (chem_tensorflow_gcn.py:116-142 semantics). Outputs must be
// zero-initialised by the caller.
void pack_gcn_dense_batch(
    const int32_t* edges,        // [E_tot, 3] (src, type, dst)
    const int64_t* edge_offsets, // [G+1]
    const float* feats,          // [N_tot, A]
    const int64_t* node_offsets, // [G+1]
    const int32_t* graph_ids,    // [b_real]
    int32_t b_real,
    int32_t v,
    int32_t annotation_size,
    int32_t hidden_size,
    float* init_out,             // [B, V, H]
    float* adj_out,              // [B, 1, V, V]
    float* mask_out) {           // [B, V]
  std::vector<double> a;
  std::vector<double> d;
  for (int32_t b = 0; b < b_real; ++b) {
    const int32_t g = graph_ids[b];
    const int64_t n0 = node_offsets[g];
    const int32_t n = (int32_t)(node_offsets[g + 1] - n0);
    a.assign((size_t)n * n, 0.0);
    d.resize(n);
    for (int64_t e = edge_offsets[g]; e < edge_offsets[g + 1]; ++e) {
      const int32_t src = edges[e * 3 + 0];
      const int32_t dst = edges[e * 3 + 2];
      a[(size_t)src * n + dst] = 1.0;
      a[(size_t)dst * n + src] = 1.0;
    }
    for (int32_t i = 0; i < n; ++i) a[(size_t)i * n + i] += 1.0;
    for (int32_t i = 0; i < n; ++i) {
      double row = 0.0;  // integer-valued entries: any order is exact
      for (int32_t j = 0; j < n; ++j) row += a[(size_t)i * n + j];
      d[i] = std::pow(row, -0.5) + 1e-7;
    }
    float* adj = adj_out + (int64_t)b * v * v;
    float* init = init_out + (int64_t)b * v * hidden_size;
    float* mask = mask_out + (int64_t)b * v;
    for (int32_t i = 0; i < n; ++i) {
      for (int32_t j = 0; j < n; ++j) {
        adj[(int64_t)i * v + j] =
            (float)((d[i] * a[(size_t)i * n + j]) * d[j]);
      }
      std::memcpy(init + (int64_t)i * hidden_size,
                  feats + (n0 + i) * annotation_size,
                  sizeof(float) * annotation_size);
      mask[i] = 1.0f;
    }
  }
}

// Fill a packed sparse super-graph batch: per-type edge lists with
// node-id offsets, per-type in-degrees, node features and graph ids.
// Outputs must be pre-initialised by the caller (edge_targets to the
// dump slot, edge_mask/init/in_degrees to zero, node_graph_ids to the
// dump graph id). Per-type edge lists are target-sorted afterwards in
// python (cheap vectorised lexsort). Returns 0 on success, -1 if any
// per-type edge capacity would overflow.
int32_t pack_sparse_batch(
    const int32_t* edges,        // [E_tot, 3]
    const int64_t* edge_offsets, // [G+1]
    const float* feats,          // [N_tot, A]
    const int64_t* node_offsets, // [G+1]
    const int32_t* graph_ids,    // [b_real]
    int32_t b_real,
    int32_t num_edge_types,      // total (doubled when untied)
    int32_t tie_fwd_bkwd,        // 1 = tied
    int32_t edge_capacity,       // per-type cap E
    int32_t annotation_size,
    int32_t hidden_size,
    int32_t* edge_sources,       // [T, E]
    int32_t* edge_targets,       // [T, E]
    float* edge_mask,            // [T, E]
    float* in_degrees,           // [N_cap, T]
    float* init_out,             // [N_cap, H]
    int32_t* node_graph_ids,     // [N_cap]
    int64_t* type_counts) {      // [T] running fill counts (zeroed in)
  const int32_t num_fwd = tie_fwd_bkwd ? num_edge_types
                                       : num_edge_types / 2;
  int64_t node_off = 0;
  for (int32_t b = 0; b < b_real; ++b) {
    const int32_t g = graph_ids[b];
    const int64_t n0 = node_offsets[g];
    const int32_t n = (int32_t)(node_offsets[g + 1] - n0);
    for (int64_t e = edge_offsets[g]; e < edge_offsets[g + 1]; ++e) {
      const int32_t src = edges[e * 3 + 0] + (int32_t)node_off;
      const int32_t typ = edges[e * 3 + 1] - 1;
      const int32_t dst = edges[e * 3 + 2] + (int32_t)node_off;
      // forward edge
      int64_t k = type_counts[typ]++;
      if (k >= edge_capacity) return -1;
      edge_sources[(int64_t)typ * edge_capacity + k] = src;
      edge_targets[(int64_t)typ * edge_capacity + k] = dst;
      edge_mask[(int64_t)typ * edge_capacity + k] = 1.0f;
      in_degrees[(int64_t)dst * num_edge_types + typ] += 1.0f;
      // backward edge (same type when tied, offset type otherwise)
      const int32_t btyp = tie_fwd_bkwd ? typ : num_fwd + typ;
      k = type_counts[btyp]++;
      if (k >= edge_capacity) return -1;
      edge_sources[(int64_t)btyp * edge_capacity + k] = dst;
      edge_targets[(int64_t)btyp * edge_capacity + k] = src;
      edge_mask[(int64_t)btyp * edge_capacity + k] = 1.0f;
      in_degrees[(int64_t)src * num_edge_types + btyp] += 1.0f;
    }
    for (int32_t i = 0; i < n; ++i) {
      std::memcpy(init_out + (node_off + i) * hidden_size,
                  feats + (n0 + i) * annotation_size,
                  sizeof(float) * annotation_size);
      node_graph_ids[node_off + i] = b;
    }
    node_off += n;
  }
  return 0;
}

// One-graph serving fast pack: everything a GraphBatch needs for a
// single request graph in one call over caller-allocated (np.empty is
// fine — every output element is written here) arrays: per-type
// (target, source)-sorted edge lanes with dump-slot padding, per-type
// in-degrees, node features zero-padded to hidden, node graph ids, and
// the type-combined (target, type, source)-sorted lane. Byte-identical
// to data/packing.py's pack_sparse_batches on a 1-graph corpus
// (pinned by tests/test_torch_native_pack.py). Returns 0 ok; negative on
// rejection — INPUT validation first (matching the numpy fallback's
// order), then capacity:
//   -3 bad edge type (outside [1, num_fwd])
//   -5 edge vertex id out of range [0, n)
//   -4 envelope exceeds the 21-bit key fields (node_capacity or
//      num_edge_types >= 2^21; caller falls back to numpy)
//   -6 bad feature geometry (annotation > hidden, or n > capacity)
//   -1 per-type edge lane overflow
//   -2 combined-lane overflow
int32_t pack_single_sparse(
    const int32_t* edges,        // [E, 3] (src, 1-based type, dst)
    int64_t n_edges,
    const float* feats,          // [n, A]
    int32_t n,                   // real node count
    int32_t annotation_size,
    int32_t num_edge_types,      // total (doubled when untied)
    int32_t tie_fwd_bkwd,
    int32_t node_capacity,
    int32_t edge_capacity,       // per-type cap E
    int64_t edges_all_cap,       // combined-lane cap (0 = lane absent)
    int32_t hidden_size,
    int32_t graph_capacity,
    int32_t* edge_sources,       // [T, E]
    int32_t* edge_targets,       // [T, E]
    float* edge_mask,            // [T, E]
    int32_t* comb_src,           // [EA] (untouched when cap 0)
    int32_t* comb_typ,           // [EA]
    int32_t* comb_tgt,           // [EA]
    float* comb_mask,            // [EA]
    float* in_degrees,           // [N_cap, T]
    float* init_out,             // [N_cap, H]
    int32_t* node_graph_ids) {   // [N_cap]
  const int32_t num_fwd = tie_fwd_bkwd ? num_edge_types
                                       : num_edge_types / 2;
  // 21-bit key fields: ids and type count must fit (serving envelopes
  // are tiny; the python caller falls back past this).
  if (node_capacity >= (1 << 21) || num_edge_types >= (1 << 21))
    return -4;
  // Feature geometry: annotations must fit the hidden rows we memcpy
  // into, and the real node count must fit the arrays.
  if (annotation_size > hidden_size || n > node_capacity) return -6;
  const int64_t m = n_edges * 2;  // directed edges after doubling
  // (type, target, source) rows, sorted once; the per-type lanes are
  // its type-partitioned runs and the combined lane is a second order.
  std::vector<int64_t> keys(m);   // typ<<42 | dst<<21 | src
  for (int64_t e = 0; e < n_edges; ++e) {
    const int64_t src = edges[e * 3 + 0];
    const int64_t typ1 = edges[e * 3 + 1];
    const int64_t dst = edges[e * 3 + 2];
    if (typ1 < 1 || typ1 > num_fwd) return -3;
    if (src < 0 || src >= n || dst < 0 || dst >= n) return -5;
    const int64_t typ = typ1 - 1;
    const int64_t btyp = tie_fwd_bkwd ? typ : num_fwd + typ;
    keys[e * 2] = (typ << 42) | (dst << 21) | src;
    keys[e * 2 + 1] = (btyp << 42) | (src << 21) | dst;
  }
  // Capacity AFTER input validation: a graph that is both malformed
  // and oversized must report the malformation (the numpy fallback
  // validates types/ids first, and the raised error must not depend
  // on which path served the request).
  if (edges_all_cap > 0 && m > edges_all_cap) return -2;
  std::sort(keys.begin(), keys.end());
  // Outputs are caller-ALLOCATED, not caller-initialised: fill pads.
  for (int32_t t = 0; t < num_edge_types; ++t) {
    for (int32_t k = 0; k < edge_capacity; ++k) {
      edge_sources[(int64_t)t * edge_capacity + k] = 0;
      edge_targets[(int64_t)t * edge_capacity + k] = node_capacity;
      edge_mask[(int64_t)t * edge_capacity + k] = 0.0f;
    }
  }
  std::memset(in_degrees, 0,
              sizeof(float) * (size_t)node_capacity * num_edge_types);
  std::memset(init_out, 0,
              sizeof(float) * (size_t)node_capacity * hidden_size);
  for (int32_t i = 0; i < node_capacity; ++i)
    node_graph_ids[i] = i < n ? 0 : graph_capacity;
  for (int32_t i = 0; i < n; ++i)
    std::memcpy(init_out + (int64_t)i * hidden_size,
                feats + (int64_t)i * annotation_size,
                sizeof(float) * annotation_size);
  int64_t fill = 0;
  int32_t cur_t = -1;
  for (int64_t i = 0; i < m; ++i) {
    const int32_t typ = (int32_t)(keys[i] >> 42);
    const int32_t dst = (int32_t)((keys[i] >> 21) & 0x1FFFFF);
    const int32_t src = (int32_t)(keys[i] & 0x1FFFFF);
    if (typ != cur_t) { cur_t = typ; fill = 0; }
    if (fill >= edge_capacity) return -1;
    edge_sources[(int64_t)typ * edge_capacity + fill] = src;
    edge_targets[(int64_t)typ * edge_capacity + fill] = dst;
    edge_mask[(int64_t)typ * edge_capacity + fill] = 1.0f;
    in_degrees[(int64_t)dst * num_edge_types + typ] += 1.0f;
    ++fill;
  }
  if (edges_all_cap > 0) {
    // (target, type, source) order — matches build_combined_lane's
    // stable lexsort((typ, tgt)) over the (tgt, src)-sorted lanes.
    for (int64_t i = 0; i < m; ++i) {
      const int64_t typ = keys[i] >> 42;
      const int64_t dst = (keys[i] >> 21) & 0x1FFFFF;
      const int64_t src = keys[i] & 0x1FFFFF;
      keys[i] = (dst << 42) | (typ << 21) | src;
    }
    std::sort(keys.begin(), keys.end());
    for (int64_t i = 0; i < m; ++i) {
      comb_tgt[i] = (int32_t)(keys[i] >> 42);
      comb_typ[i] = (int32_t)((keys[i] >> 21) & 0x1FFFFF);
      comb_src[i] = (int32_t)(keys[i] & 0x1FFFFF);
      comb_mask[i] = 1.0f;
    }
    for (int64_t i = m; i < edges_all_cap; ++i) {
      comb_src[i] = 0;
      comb_typ[i] = 0;
      comb_tgt[i] = node_capacity;
      comb_mask[i] = 0.0f;
    }
  }
  return 0;
}

// Fill a packed GCN edge-list batch (the `gcn` variant): per graph,
// the D^{-1/2}(sym(A)+I)D^{-1/2} normalized adjacency as row-major COO
// with node-id offsets, computed WITHOUT materializing the dense n x n
// matrix (sort+dedup of the symmetrized pair list) but with the exact
// float semantics of the numpy pipeline
// (packing.graph_to_normalized_adjacency: integer-valued row sums are
// order-exact in double; each weight is fl(fl(d_i*a_ij)*d_j); diagonal
// a_ii is 2.0 when the graph carries an explicit self-loop edge) so
// eval batches are bit-identical to the python packer. Outputs must be
// pre-initialised by the caller (edge_targets to the node dump slot,
// weights/init to zero, node_graph_ids to the dump graph id). Returns
// the filled COO count, -1 on COO capacity overflow, or -4 when a
// graph's node count exceeds the 21-bit sort-key field (the python
// packer takes over).
int64_t pack_gcn_batch(
    const int32_t* edges,        // [E_tot, 3] (src, type, dst)
    const int64_t* edge_offsets, // [G+1]
    const float* feats,          // [N_tot, A]
    const int64_t* node_offsets, // [G+1]
    const int32_t* graph_ids,    // [b_real]
    int32_t b_real,
    int64_t edge_capacity,       // COO cap (caps.edges_per_type)
    int32_t annotation_size,
    int32_t hidden_size,
    int32_t* edge_sources,       // [E_cap]
    int32_t* edge_targets,       // [E_cap]
    float* edge_weights,         // [E_cap]
    float* init_out,             // [N_cap, H]
    int32_t* node_graph_ids) {   // [N_cap]
  std::vector<int64_t> pairs;
  std::vector<double> d;
  std::vector<uint8_t> self_loop;
  int64_t node_off = 0;
  int64_t fill = 0;
  for (int32_t b = 0; b < b_real; ++b) {
    const int32_t g = graph_ids[b];
    const int64_t n0 = node_offsets[g];
    const int32_t n = (int32_t)(node_offsets[g + 1] - n0);
    if (n >= (1 << 21)) return -4;
    const int64_t e0 = edge_offsets[g], e1 = edge_offsets[g + 1];
    pairs.clear();
    pairs.reserve((size_t)(2 * (e1 - e0) + n));
    self_loop.assign((size_t)n, 0);
    for (int64_t e = e0; e < e1; ++e) {
      const int64_t src = edges[e * 3 + 0];
      const int64_t dst = edges[e * 3 + 2];
      if (src == dst) {
        self_loop[(size_t)src] = 1;  // a_ii = 1 + eye = 2.0
      } else {
        pairs.push_back((src << 21) | dst);
        pairs.push_back((dst << 21) | src);
      }
    }
    for (int64_t i = 0; i < n; ++i)
      pairs.push_back((i << 21) | i);  // the +I diagonal
    std::sort(pairs.begin(), pairs.end());
    pairs.erase(std::unique(pairs.begin(), pairs.end()), pairs.end());
    // Row sums of the integer-valued matrix (order-exact in double):
    // off-diagonal unique neighbours are 1.0, diagonal 1.0 or 2.0.
    d.assign((size_t)n, 0.0);
    for (const int64_t key : pairs) {
      const int64_t i = key >> 21;
      const int64_t j = key & 0x1FFFFF;
      d[(size_t)i] += (i == j && self_loop[(size_t)i]) ? 2.0 : 1.0;
    }
    for (int32_t i = 0; i < n; ++i)
      d[(size_t)i] = std::pow(d[(size_t)i], -0.5) + 1e-7;
    if (fill + (int64_t)pairs.size() > edge_capacity) return -1;
    for (const int64_t key : pairs) {
      const int64_t i = key >> 21;   // target row
      const int64_t j = key & 0x1FFFFF;  // source col
      const double a = (i == j && self_loop[(size_t)i]) ? 2.0 : 1.0;
      edge_targets[fill] = (int32_t)(i + node_off);
      edge_sources[fill] = (int32_t)(j + node_off);
      edge_weights[fill] =
          (float)((d[(size_t)i] * a) * d[(size_t)j]);
      ++fill;
    }
    for (int32_t i = 0; i < n; ++i) {
      std::memcpy(init_out + (node_off + i) * hidden_size,
                  feats + (n0 + i) * annotation_size,
                  sizeof(float) * annotation_size);
      node_graph_ids[node_off + i] = b;
    }
    node_off += n;
  }
  return fill;
}

}  // extern "C"
