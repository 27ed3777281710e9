// dbgtpu_torch native runtime: read parsing + 2-bit packing.
//
// Counterpart of the reference's C++ host runtime
// (Aligner::getReads, aligner.cpp:46-117): parses FASTA/FASTQ with the
// reference's acceptance rules, in one pass over threads, into flat
// arrays the caller allocated — 2-bit codes, N-mask, record offsets,
// headers — ready for numpy / device batching.
// Behavior contract is dbgtpu_torch/io/fasta.py (the executable spec); the
// two are parity-tested byte-for-byte.
//
// Build: g++ -O3 -march=native -shared -fPIC -pthread io.cpp -o libdbgtpu_torch_io.so
// (driven by dbgtpu_torch/native/__init__.py, cached, with python fallback).

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <system_error>
#include <thread>
#include <vector>

namespace {

// One chunk's records, written in one pass into the caller's arrays:
// codes, nmask and header bytes from the chunk's own input offset on
// (a chunk never writes more bytes than it reads, so the chunks'
// regions do not overlap), and each accepted record's end offsets,
// relative to the chunk, into its own slots of seq_off / hdr_off.
struct Writer {
    uint8_t* codes;
    uint8_t* nmask;
    uint8_t* hdrs;
    int64_t* seq_end;
    int64_t* hdr_end;
    int64_t rec_cap;
    int64_t n = 0, seq = 0, hdr = 0;
    // in-progress record state
    int64_t rec_seq = 0, rec_hdr = 0;
    uint8_t bad = 0;
    bool open = false, overflow = false;

    void open_record(const char* h, size_t len) {
        rec_seq = seq;
        rec_hdr = hdr;
        memcpy(hdrs + hdr, h, len);
        hdr += (int64_t)len;
        bad = 0;
        open = true;
    }
    // A=0 C=1 G=2 T=3 N=3 (other bytes reject the record, so their
    // codes are never kept); branch-free so that it vectorises (the
    // validity is a sum: an OR of the compares becomes a 64-bit bit
    // test, which does not).
    void add_seq(const char* s, size_t len) {
        uint8_t* c = codes + seq;
        uint8_t* m = nmask + seq;
        uint8_t b = 0;
        for (size_t i = 0; i < len; ++i) {
            uint8_t x = (uint8_t)s[i];
            uint8_t isn = x == 'N';
            uint8_t ok = (uint8_t)(x == 'A') + (uint8_t)(x == 'C') +
                         (uint8_t)(x == 'G') + (uint8_t)(x == 'T') + isn;
            c[i] = (uint8_t)((((x >> 1) ^ (x >> 2)) & 3) | (isn * 3));
            m[i] = isn;
            b |= (uint8_t)(ok ^ 1);
        }
        bad |= b;
        seq += (int64_t)len;
    }
    // close; keep iff valid && len > 2 && len > min_len
    void close_record(int64_t min_len) {
        if (!open) return;
        open = false;
        int64_t len = seq - rec_seq;
        if (!bad && len > 2 && len > min_len) {
            if (n >= rec_cap) {
                overflow = true;
                return;
            }
            seq_end[n] = seq;
            hdr_end[n] = hdr;
            ++n;
        } else {
            seq = rec_seq;
            hdr = rec_hdr;
        }
    }
};

// FASTA: records joined across lines, accepted iff charset ok &&
// len > 2 && len > k; lines before the first header are skipped.
void parse_fasta(Writer& w, const char* p, const char* end, int64_t k) {
    while (p < end) {
        const char* nl = (const char*)memchr(p, '\n', (size_t)(end - p));
        const char* e = nl ? nl : end;
        if (e > p && *p == '>') {
            w.close_record(k);
            w.open_record(p, (size_t)(e - p));
        } else if (w.open) {
            w.add_seq(p, (size_t)(e - p));
        }
        if (!nl) break;
        p = nl + 1;
    }
    w.close_record(k);
}

// FASTQ: 4-line records, accepted iff charset ok && len > 2 (no len > k
// rule, matching the reference; its last-record duplication defect is
// NOT replicated).  A truncated trailing record (missing '+' or qual
// line) still yields its sequence, then parsing stops.
void parse_fastq(Writer& w, const char* buf, size_t n) {
    size_t i = 0;
    auto next_line = [&](const char*& s, size_t& len) -> bool {
        if (i >= n) return false;
        const char* nl = (const char*)memchr(buf + i, '\n', n - i);
        s = buf + i;
        len = nl ? (size_t)(nl - s) : n - i;
        i += len + (nl ? 1 : 0);
        return true;
    };
    for (;;) {
        const char *h, *s, *pl, *q;
        size_t hl, sl, pll, ql;
        if (!next_line(h, hl)) break;
        if (!next_line(s, sl)) { s = nullptr; sl = 0; }
        bool have_plus = next_line(pl, pll);
        bool have_qual = next_line(q, ql);
        w.open_record(h, hl);
        if (s) w.add_seq(s, sl);
        w.close_record(2);  // len > 2 only (no k rule in fastq)
        if (!have_plus || !have_qual) break;
    }
}

// Runs fn on a new thread of pool, or here when no thread can start.
template <class F>
void spawn(std::vector<std::thread>& pool, F fn) {
    try {
        pool.emplace_back(fn);
    } catch (const std::system_error&) {
        fn();
    }
}

}  // namespace

extern "C" {

// Parse a read file straight into the caller's arrays, each of
// cap_bytes (>= the file's size) bytes: codes (2-bit codes), nmask (0/1
// for 'N') and headers (header lines, no newline); seq_off and hdr_off
// of cap_recs slots receive the n + 1 record offsets.  A FASTA file is
// cut into up to `threads` chunks at "\n>" (every '>' line is a header,
// so no record spans a cut), parsed at once, then closed up in order.
// A chunk of b bytes holds at most b / min_rec accepted records
// (min_rec: the fewest bytes one takes), so chunk t's offset slots start
// at floor(its start / min_rec) + t.  FASTQ is one chunk ('@' may open
// a quality line).  out[0..3] = records, sequence bytes, header bytes,
// chunks.  Returns 0, -1 when the file cannot be read, -2 when it
// outgrows the arrays.
int32_t dbg_parse_reads_into(
    const char* path, int64_t k, int32_t fastq, int32_t threads,
    int64_t min_rec, int64_t cap_bytes, int64_t cap_recs,
    uint8_t* codes, uint8_t* nmask, uint8_t* headers,
    int64_t* seq_off, int64_t* hdr_off, int64_t* out) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return -1;
    struct stat st;
    if (fstat(fd, &st) != 0) {
        close(fd);
        return -1;
    }
    int64_t size = (int64_t)st.st_size;
    if (size > cap_bytes || cap_recs < 2) {
        close(fd);
        return -2;
    }
    seq_off[0] = hdr_off[0] = 0;
    out[0] = out[1] = out[2] = 0;
    out[3] = 1;
    if (size == 0) {
        close(fd);
        return 0;
    }
    void* map = mmap(nullptr, (size_t)size, PROT_READ, MAP_PRIVATE, fd, 0);
    close(fd);
    if (map == MAP_FAILED) return -1;
    const char* buf = (const char*)map;

    // chunk starts: 0, then the first "\n>" at or after t * size / T
    std::vector<int64_t> cut{0};
    if (!fastq) {
        for (int32_t t = 1; t < threads; ++t) {
            int64_t from = size * t / threads;
            if (from <= cut.back()) from = cut.back() + 1;
            if (from >= size) break;
            const char* hit = (const char*)memmem(
                buf + from - 1, (size_t)(size - from + 1), "\n>", 2);
            if (!hit) break;
            cut.push_back(hit + 1 - buf);
        }
    }
    cut.push_back(size);
    size_t nc = cut.size() - 1;
    std::vector<int64_t> rec_at(nc + 1);
    for (size_t t = 0; t < nc; ++t)
        rec_at[t] = cut[t] / min_rec + (int64_t)t;
    rec_at[nc] = cap_recs - 1;
    std::vector<Writer> ws(nc);
    for (size_t t = 0; t < nc; ++t) {
        Writer& w = ws[t];
        w.codes = codes + cut[t];
        w.nmask = nmask + cut[t];
        w.hdrs = headers + cut[t];
        w.seq_end = seq_off + 1 + rec_at[t];
        w.hdr_end = hdr_off + 1 + rec_at[t];
        w.rec_cap = rec_at[t + 1] - rec_at[t];
    }
    auto run = [&](size_t t) {
        if (fastq)
            parse_fastq(ws[t], buf, (size_t)size);
        else
            parse_fasta(ws[t], buf + cut[t], buf + cut[t + 1], k);
    };
    std::vector<std::thread> pool;
    for (size_t t = 1; t < nc; ++t) spawn(pool, [&run, t] { run(t); });
    run(0);
    for (auto& th : pool) th.join();
    munmap(map, (size_t)size);

    for (const Writer& w : ws)
        if (w.overflow) return -2;
    // close the chunks up in order: each moves down, never past the
    // next chunk's unread region, so one array's moves run in turn; the
    // three arrays move at once.  Then the offsets are rebased in place
    // (a slot only moves down, to one already read).
    auto close_up = [&](uint8_t* base, uint8_t* Writer::*at,
                        int64_t Writer::*len) {
        int64_t o = 0;
        for (const Writer& w : ws) {
            memmove(base + o, w.*at, (size_t)(w.*len));
            o += w.*len;
        }
    };
    if (nc > 1) {
        pool.clear();
        spawn(pool, [&] { close_up(codes, &Writer::codes, &Writer::seq); });
        spawn(pool, [&] { close_up(nmask, &Writer::nmask, &Writer::seq); });
        close_up(headers, &Writer::hdrs, &Writer::hdr);
        for (auto& th : pool) th.join();
    }
    int64_t n = 0, sb = 0, hb = 0;
    for (const Writer& w : ws) {
        for (int64_t i = 0; i < w.n; ++i) {
            seq_off[1 + n + i] = sb + w.seq_end[i];
            hdr_off[1 + n + i] = hb + w.hdr_end[i];
        }
        n += w.n;
        sb += w.seq;
        hb += w.hdr;
    }
    out[0] = n;
    out[1] = sb;
    out[2] = hb;
    out[3] = (int64_t)nc;
    return 0;
}

// ---------------------------------------------------------------- writer

// Format the paths file: per aligned read, header line + newline +
// "v." joined path + newline (reference printPath, aligner.cpp:600-609).
// paths_flat holds each read's path values back to back (path_off[i] ..
// path_off[i+1]); reads with status not in {1,2} are skipped.
// Returns malloc'd buffer; *out_len receives its length.
uint8_t* dbg_format_paths(
    const uint8_t* headers, const int64_t* hdr_off,
    const int32_t* status, const int64_t* path_off,
    const int32_t* paths_flat, int64_t n, int64_t* out_len) {
    std::vector<uint8_t> out;
    out.reserve((size_t)n * 32);
    char tmp[16];
    for (int64_t i = 0; i < n; ++i) {
        if (status[i] != 1 && status[i] != 2) continue;
        out.insert(out.end(), headers + hdr_off[i], headers + hdr_off[i + 1]);
        out.push_back('\n');
        for (int64_t j = path_off[i]; j < path_off[i + 1]; ++j) {
            int len = snprintf(tmp, sizeof(tmp), "%d.", paths_flat[j]);
            out.insert(out.end(), tmp, tmp + len);
        }
        out.push_back('\n');
    }
    uint8_t* res = (uint8_t*)malloc(out.size() ? out.size() : 1);
    memcpy(res, out.data(), out.size());
    *out_len = (int64_t)out.size();
    return res;
}

// Format the notAligned file: per NON-aligned read (status not 1/2),
// header line + newline + original sequence chars + newline (reference
// notAligned.fa writes, alignerGreedy.cpp:400-427; receives both
// no-overlap and overlap-but-unaligned reads, SURVEY.md §4.1 item 3).
// `chars` is the whole file's ASCII base stream (N restored).
uint8_t* dbg_format_notaligned(
    const uint8_t* headers, const int64_t* hdr_off,
    const int32_t* status, const uint8_t* chars,
    const int64_t* seq_off, int64_t n, int64_t* out_len) {
    std::vector<uint8_t> out;
    out.reserve((size_t)n * 16);
    for (int64_t i = 0; i < n; ++i) {
        if (status[i] == 1 || status[i] == 2) continue;
        out.insert(out.end(), headers + hdr_off[i], headers + hdr_off[i + 1]);
        out.push_back('\n');
        out.insert(out.end(), chars + seq_off[i], chars + seq_off[i + 1]);
        out.push_back('\n');
    }
    uint8_t* res = (uint8_t*)malloc(out.size() ? out.size() : 1);
    memcpy(res, out.data(), out.size());
    *out_len = (int64_t)out.size();
    return res;
}

// Correction mode (-c): per aligned read, header + the genomic
// sequence recovered along its path + newline (reference recoverPath,
// aligner.cpp:270-290: splice unitigs with k-1 overlaps, slice
// [offset, offset+readLen), RC back when the read aligned as RC —
// alignerGreedy.cpp:394-399).  `pool` holds 2-bit codes of all unitigs
// back to back (uoff/ulen index it, ids 1-based, negative = RC).
uint8_t* dbg_format_corrected(
    const uint8_t* headers, const int64_t* hdr_off,
    const int32_t* status, const int64_t* path_off, const int32_t* flat,
    const int64_t* seq_off,
    const uint8_t* pool, const int32_t* uoff, const int32_t* ulen,
    int32_t k, int64_t n, int64_t* out_len) {
    static const char ACGT[] = "ACGT";
    std::vector<uint8_t> out;
    out.reserve((size_t)n * 64);
    std::vector<uint8_t> tmp;
    for (int64_t i = 0; i < n; ++i) {
        if (status[i] != 1 && status[i] != 2) continue;
        int64_t rlen = seq_off[i + 1] - seq_off[i];
        const int32_t* p = flat + path_off[i];
        int64_t m = path_off[i + 1] - path_off[i];
        if (m < 2) continue;
        int64_t offset = p[0];
        tmp.clear();
        for (int64_t j = 1; j < m; ++j) {
            int32_t sid = p[j];
            int32_t id = sid < 0 ? -sid : sid;
            int32_t len = ulen[id];
            const uint8_t* base = pool + uoff[id];
            int64_t start = (j == 1) ? 0 : (k - 1);
            for (int64_t t = start; t < len; ++t)
                tmp.push_back(sid > 0 ? base[t]
                                      : (uint8_t)(3 - base[len - 1 - t]));
            if ((int64_t)tmp.size() >= offset + rlen) break;
        }
        out.insert(out.end(), headers + hdr_off[i], headers + hdr_off[i + 1]);
        out.push_back('\n');
        int64_t avail = (int64_t)tmp.size() - offset;
        int64_t w = rlen < avail ? rlen : avail;   // defensive clamp
        if (status[i] == 1) {
            for (int64_t t = 0; t < w; ++t)
                out.push_back((uint8_t)ACGT[tmp[offset + t]]);
        } else {
            for (int64_t t = 0; t < w; ++t)
                out.push_back((uint8_t)ACGT[3 - tmp[offset + w - 1 - t]]);
        }
        out.push_back('\n');
    }
    uint8_t* res = (uint8_t*)malloc(out.size() ? out.size() : 1);
    memcpy(res, out.data(), out.size());
    *out_len = (int64_t)out.size();
    return res;
}

// Pack a batch of parsed records straight into the device H2D layout
// (engine.runner pack_words_batch semantics): records [s0, s0+nb) of
// the flat code/nmask streams, padded to B rows x L bases, emitted as
// 2-bit words (base j at bits 2*(j%16) of word j/16) and 1-bit N-mask
// words.  Caller provides zeroed outputs: words [B, (L+15)/16],
// nmbits [B, (L+31)/32], lens [B].
void dbg_pack_batch(
    const uint8_t* codes, const uint8_t* nmask, const int64_t* seq_off,
    int64_t s0, int64_t nb, int64_t L,
    uint32_t* words, uint32_t* nmbits, int32_t* lens_out) {
    int64_t Lw = (L + 15) / 16, Lb = (L + 31) / 32;
    for (int64_t i = 0; i < nb; ++i) {
        int64_t off = seq_off[s0 + i];
        int64_t n = seq_off[s0 + i + 1] - off;
        if (n > L) n = L;
        lens_out[i] = (int32_t)n;
        uint32_t* w = words + i * Lw;
        uint32_t* nm = nmbits + i * Lb;
        const uint8_t* c = codes + off;
        const uint8_t* q = nmask + off;
        for (int64_t j = 0; j < n; ++j) {
            w[j >> 4] |= (uint32_t)(c[j] & 3) << (2 * (j & 15));
            if (q[j]) nm[j >> 5] |= (uint32_t)1 << (j & 31);
        }
    }
}

void dbg_free_buf(uint8_t* p) { free(p); }

}  // extern "C"
