// Radix prefix index over full token blocks: the C++ core.
//
// Native counterpart of runtime/kv_cache.py::RadixPrefixIndex, with the
// same semantics, exchangeable behind runtime.kv_cache.make_radix_index.
// It runs on the host, on the scheduler's path: the block manager probes
// it for every admitted prompt, while the KV pages stay on the device and
// are referred to here only by integer block ids.
//
// Traversal allocates nothing. A chunk is addressed by an FNV-1a hash over
// its raw int32 bytes; each node keeps its children in a flat vector of
// (hash, child*) scanned linearly (prefix trees branch rarely: shared
// system prompts diverge at one point), with a full memcmp of the stored
// edge on a hash match.
//
// C ABI (ctypes): every function is extern "C"; handles are opaque
// pointers. The ABI is the one of the JAX package's native/ library, so a
// caller can hold either.

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

inline uint64_t chunk_hash(const int32_t* p, int n) {
    uint64_t h = 1469598103934665603ULL;  // FNV offset basis
    const uint8_t* b = reinterpret_cast<const uint8_t*>(p);
    for (int i = 0; i < n * 4; ++i) {
        h ^= b[i];
        h *= 1099511628211ULL;  // FNV prime
    }
    return h;
}

struct Node {
    std::vector<std::pair<uint64_t, Node*>> children;
    Node* parent = nullptr;
    std::vector<int32_t> edge;   // owned copy of the chunk tokens
    uint64_t edge_hash = 0;
    int64_t block_id = -1;

    Node* find_child(uint64_t h, const int32_t* chunk, int bs) {
        for (auto& c : children) {
            if (c.first == h &&
                std::memcmp(c.second->edge.data(), chunk,
                            bs * sizeof(int32_t)) == 0) {
                return c.second;
            }
        }
        return nullptr;
    }
};

struct RadixIndex {
    int block_size;
    Node root;
    std::unordered_map<int64_t, Node*> by_block;

    explicit RadixIndex(int bs) : block_size(bs) {}

    ~RadixIndex() { destroy_children(&root); }

    void destroy_children(Node* n) {
        for (auto& kv : n->children) {
            destroy_children(kv.second);
            delete kv.second;
        }
        n->children.clear();
    }
};

}  // namespace

extern "C" {

void* radix_new(int block_size) {
    if (block_size <= 0) return nullptr;
    return new RadixIndex(block_size);
}

void radix_destroy(void* h) { delete static_cast<RadixIndex*>(h); }

// Longest cached full-block prefix: writes up to max_out physical block ids
// into out_blocks; returns the number matched.
int64_t radix_match(void* h, const int32_t* tokens, int64_t n_tokens,
                    int64_t* out_blocks, int64_t max_out) {
    auto* idx = static_cast<RadixIndex*>(h);
    const int bs = idx->block_size;
    const int64_t n_full = n_tokens / bs;
    Node* node = &idx->root;
    int64_t matched = 0;
    for (int64_t i = 0; i < n_full && matched < max_out; ++i) {
        const int32_t* chunk = tokens + i * bs;
        Node* child = node->find_child(chunk_hash(chunk, bs), chunk, bs);
        if (child == nullptr) break;
        out_blocks[matched++] = child->block_id;
        node = child;
    }
    return matched;
}

// Index blocks as the cache of the full token blocks; already-present prefix
// nodes are left untouched. Returns the number of newly indexed blocks.
int64_t radix_insert(void* h, const int32_t* tokens, int64_t n_tokens,
                     const int64_t* blocks, int64_t n_blocks) {
    auto* idx = static_cast<RadixIndex*>(h);
    const int bs = idx->block_size;
    int64_t n_full = n_tokens / bs;
    if (n_blocks < n_full) n_full = n_blocks;
    Node* node = &idx->root;
    int64_t added = 0;
    for (int64_t i = 0; i < n_full; ++i) {
        const int32_t* chunk = tokens + i * bs;
        const uint64_t hash = chunk_hash(chunk, bs);
        Node* child = node->find_child(hash, chunk, bs);
        if (child == nullptr) {
            child = new Node();
            child->parent = node;
            child->edge.assign(chunk, chunk + bs);
            child->edge_hash = hash;
            child->block_id = blocks[i];
            node->children.emplace_back(hash, child);
            idx->by_block[blocks[i]] = child;
            ++added;
        }
        node = child;
    }
    return added;
}

int radix_contains(void* h, int64_t block_id) {
    auto* idx = static_cast<RadixIndex*>(h);
    return idx->by_block.count(block_id) ? 1 : 0;
}

int radix_is_leaf(void* h, int64_t block_id) {
    auto* idx = static_cast<RadixIndex*>(h);
    auto it = idx->by_block.find(block_id);
    return (it != idx->by_block.end() && it->second->children.empty()) ? 1 : 0;
}

// 0 = removed, 1 = absent (no-op), -1 = interior (refused)
int radix_remove(void* h, int64_t block_id) {
    auto* idx = static_cast<RadixIndex*>(h);
    auto it = idx->by_block.find(block_id);
    if (it == idx->by_block.end()) return 1;
    Node* node = it->second;
    if (!node->children.empty()) return -1;
    idx->by_block.erase(it);
    auto& sibs = node->parent->children;
    for (size_t i = 0; i < sibs.size(); ++i) {
        if (sibs[i].second == node) {
            sibs[i] = sibs.back();
            sibs.pop_back();
            break;
        }
    }
    delete node;
    return 0;
}

int64_t radix_size(void* h) {
    return static_cast<int64_t>(static_cast<RadixIndex*>(h)->by_block.size());
}

}  // extern "C"
