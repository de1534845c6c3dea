// Native IO + alignment-ingest hot path for nextpolish2_tpu.
//
// Covers the reference's native layer (rust-htslib/htslib BAM decode, Cargo.toml:21)
// plus its per-read CPU hot loops (fill_with_cigar main.rs:386-440, trim
// main.rs:446-513, AlignSeq packing main.rs:278-338, update_msas kmer stream
// main.rs:576-589) in one pass: BGZF -> BAM records -> filter -> expand -> trim ->
// (t_pos, packed 3-mer key) stream per alignment.
//
// Memory discipline (v3): on the target VMs, first-touch page faults are
// serviced by the hypervisor at ~4-40 MB/s while mapped memory writes at
// ~3 GB/s, so this module (a) never stages GB-scale copies — extraction counts
// first, then fills the caller's exact-size buffers directly — and (b) relies
// on the package-level mallopt() (no mmap, no trim) so freed heap memory is
// reused instead of re-provisioned.
//
// C ABI (ctypes); caller provides output buffers. Build: build.sh ->
// libnp2native.so (requires zlib).

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <cerrno>
#include <chrono>
#include <deque>
#include <thread>
#include <vector>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <algorithm>
#include <atomic>
#include <memory>
#include <mutex>
#include <fcntl.h>
#include <unistd.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <zlib.h>

// NP2_TIMING=1: per-stage timings on stderr (perf debugging on slow VMs).
static bool np2_timing() {
  static int v = -1;
  if (v < 0) { const char* e = getenv("NP2_TIMING"); v = (e && *e == '1') ? 1 : 0; }
  return v == 1;
}
static double np2_now() {
  return std::chrono::duration<double>(
      std::chrono::steady_clock::now().time_since_epoch()).count();
}
#define NP2_T(label, t0)                                             \
  do {                                                               \
    if (np2_timing())                                                \
      fprintf(stderr, "[np2 %-28s] %8.2fs\n", label, np2_now() - (t0)); \
  } while (0)

namespace {

// ---------- BGZF / BAM reading ----------

struct Bytes {
  std::vector<uint8_t> d;
};

// Inflate an entire BGZF (or plain gzip) file into memory.
static bool inflate_file(const char* path, Bytes& out) {
  gzFile f = gzopen(path, "rb");
  if (!f) return false;
  gzbuffer(f, 1 << 20);
  size_t cap = 1 << 22;
  out.d.resize(cap);
  size_t n = 0;
  for (;;) {
    if (n + (1 << 20) > out.d.size()) out.d.resize(out.d.size() * 2);
    int got = gzread(f, out.d.data() + n, 1 << 20);
    if (got < 0) { gzclose(f); return false; }
    if (got == 0) break;
    n += (size_t)got;
  }
  gzclose(f);
  out.d.resize(n);
  return true;
}

static inline uint32_t rd_u32(const uint8_t* p) {
  uint32_t v; memcpy(&v, p, 4); return v;
}
static inline int32_t rd_i32(const uint8_t* p) {
  int32_t v; memcpy(&v, p, 4); return v;
}
static inline uint16_t rd_u16(const uint8_t* p) {
  uint16_t v; memcpy(&v, p, 2); return v;
}
static inline uint64_t rd_u64(const uint8_t* p) {
  uint64_t v; memcpy(&v, p, 8); return v;
}

// ---------- BGZF random access (indexed, bounded-memory ingest) ----------
//
// The reference random-accesses each contig via htslib's BAI index
// (main.rs:1741-1745 IndexedReader::fetch; secondary.rs:28-60). Earlier
// rounds of this module instead inflated the ENTIRE BAM into host RAM and
// linear-scanned the stream per contig — unusable at human scale (a 30-60x
// HiFi BAM is ~100-250 GB decompressed, per host). This section keeps only
// the compressed file on disk plus a per-contig decompressed window in RAM:
//
//   * np2_open streams BGZF blocks just far enough to parse the BAM header,
//     then obtains per-tid virtual-offset ranges [vbeg, vend) from, in
//     order of preference: the sidecar .bai index, a cached .np2idx linear
//     index, or a one-pass bounded-memory streaming scan whose result is
//     cached to <bam>.np2idx (NP2_NO_IDXCACHE=1 disables the cache).
//   * np2_extract_begin3 preads ONLY the contig's compressed block range
//     and inflates it multi-threaded into an exact-size buffer;
//     np2_extract_fetch3 frees the window. Peak ingest RSS is therefore
//     O(largest contig's records), matching the reference's design.
//
// Virtual offsets are the standard BGZF (coffset << 16 | within-block
// uoffset). Non-BGZF inputs (plain gzip) keep the legacy whole-file-resident
// path — documented as unbounded and only hit for non-standard files.

static int64_t file_pread(int fd, void* buf, int64_t n, int64_t off) {
  int64_t got = 0;
  while (got < n) {
    ssize_t r = pread(fd, (char*)buf + got, (size_t)(n - got),
                      (off_t)(off + got));
    if (r < 0) { if (errno == EINTR) continue; return -1; }
    if (r == 0) break;
    got += r;
  }
  return got;
}

// Total size of the BGZF block starting at p (needs the 12+XLEN header bytes
// in view; 18 suffice for htslib-style blocks), or -1 if not a BGZF block.
static int bgzf_bsize(const uint8_t* p, int64_t avail) {
  if (avail < 18 || p[0] != 0x1f || p[1] != 0x8b || p[2] != 8 || !(p[3] & 4))
    return -1;
  int xlen = rd_u16(p + 10);
  if (12 + xlen > avail) return -1;
  const uint8_t* x = p + 12;
  const uint8_t* xe = x + xlen;
  while (x + 4 <= xe) {
    int slen = rd_u16(x + 2);
    if (x[0] == 66 && x[1] == 67 && slen == 2 && x + 6 <= xe)
      return (int)rd_u16(x + 4) + 1;
    x += 4 + slen;
  }
  return -1;
}

// Reusable raw-deflate decompressor (one z_stream per thread, inflateReset
// between blocks — initializing per 64 KB block measurably costs).
struct Inflater {
  z_stream zs{};
  bool ok;
  Inflater() { ok = inflateInit2(&zs, -15) == Z_OK; }
  ~Inflater() { if (ok) inflateEnd(&zs); }
  // Inflate one complete block (p, bsize) into out; returns ISIZE or -1.
  int block(const uint8_t* p, int bsize, uint8_t* out, int out_cap) {
    if (!ok) return -1;
    int xlen = rd_u16(p + 10);
    int coff = 12 + xlen;
    int clen = bsize - coff - 8;
    if (clen < 0) return -1;
    int usize = (int)rd_u32(p + bsize - 4);
    if (usize < 0 || usize > out_cap) return -1;
    if (usize == 0) return 0;
    inflateReset(&zs);
    zs.next_in = (Bytef*)(p + coff);
    zs.avail_in = (uInt)clen;
    zs.next_out = out;
    zs.avail_out = (uInt)usize;
    int r = inflate(&zs, Z_FINISH);
    return (r == Z_STREAM_END && zs.avail_out == 0) ? usize : -1;
  }
};

// Sequential block reader: preads the compressed file in large chunks and
// yields one decompressed block at a time (bounded memory).
struct BgzfScan {
  int fd;
  int64_t fsize;
  int64_t coff = 0;                  // next block's compressed offset
  std::vector<uint8_t> cbuf;
  int64_t cbase = 0, clen = 0;       // cbuf holds file bytes [cbase, cbase+clen)
  Inflater inf;
  BgzfScan(int fd_, int64_t fsize_) : fd(fd_), fsize(fsize_) {}
  bool ensure(int64_t need) {
    if (coff + need <= cbase + clen) return true;
    int64_t keep = cbase + clen - coff;
    if (keep < 0) keep = 0;
    if (keep > 0 && coff > cbase)
      memmove(cbuf.data(), cbuf.data() + (coff - cbase), (size_t)keep);
    cbase = coff;
    clen = keep;
    int64_t want = std::max<int64_t>(need, 4 << 20);
    if ((int64_t)cbuf.size() < want) cbuf.resize((size_t)want);
    int64_t avail = fsize - (cbase + clen);
    int64_t ask = std::min(want - clen, avail);
    if (ask > 0) {
      int64_t got = file_pread(fd, cbuf.data() + clen, ask, cbase + clen);
      if (got < 0) return false;
      clen += got;
    }
    return coff + need <= cbase + clen;
  }
  // Next block -> out (resized as needed); returns ISIZE (0 for the EOF
  // marker block), -1 at clean EOF, -2 on corrupt input.
  int next(std::vector<uint8_t>& out, int64_t* block_coff) {
    if (coff >= fsize) return -1;
    if (!ensure(18)) return -2;
    const uint8_t* p = cbuf.data() + (coff - cbase);
    int bsize = bgzf_bsize(p, cbase + clen - coff);
    if (bsize < 0) return -2;
    if (!ensure(bsize)) return -2;
    p = cbuf.data() + (coff - cbase);
    int usize = (int)rd_u32(p + bsize - 4);
    if (usize < 0 || usize > (1 << 20)) return -2;  // spec max is 2^16
    if ((int)out.size() < usize) out.resize((size_t)usize);
    if (inf.block(p, bsize, out.data(), (int)out.size()) != usize) return -2;
    *block_coff = coff;
    coff += bsize;
    return usize;
  }
};

// Bounds-checked incremental BAM header parse: 1 = done (refs + *hdr_size
// set), 0 = need more bytes, -1 = corrupt.
static int try_parse_bam_header(
    const uint8_t* p, size_t n,
    std::vector<std::pair<std::string, int64_t>>& refs, size_t* hdr_size) {
  if (n < 4) return 0;
  if (memcmp(p, "BAM\x01", 4) != 0) return -1;
  if (n < 12) return 0;
  uint32_t l_text = rd_u32(p + 4);
  size_t off = 8 + (size_t)l_text;
  if (off + 4 > n) return 0;
  int32_t n_ref = rd_i32(p + off);
  off += 4;
  if (n_ref < 0) return -1;
  std::vector<std::pair<std::string, int64_t>> tmp;
  tmp.reserve((size_t)n_ref);
  for (int32_t i = 0; i < n_ref; i++) {
    if (off + 4 > n) return 0;
    uint32_t l_name = rd_u32(p + off);
    off += 4;
    if (l_name == 0) return -1;
    if (off + l_name + 4 > n) return 0;
    tmp.emplace_back(std::string((const char*)p + off, l_name - 1),
                     (int64_t)rd_i32(p + off + l_name));
    off += l_name + 4;
  }
  refs = std::move(tmp);
  *hdr_size = off;
  return 1;
}

// Stream every BAM record of a BGZF file with bounded memory. cb(voff, q) gets
// the record's virtual offset and a payload pointer (q is just past the
// block_size field; q[-4] is readable — the parse_rec contract); returning
// false stops the walk early (used for header-only parses). end_voff_out (may
// be null) receives the virtual offset just past the last record consumed.
// Returns 0 or a negative error.
template <typename CB>
static int bgzf_walk(int fd, int64_t fsize,
                     std::vector<std::pair<std::string, int64_t>>* refs_out,
                     uint64_t* end_voff_out, CB&& cb) {
  BgzfScan sc(fd, fsize);
  std::vector<uint8_t> blk;
  std::vector<uint8_t> ubuf;          // rolling decompressed window
  std::deque<std::pair<int64_t, int64_t>> blocks;  // (u_start, coff)
  int64_t u_base = 0;                 // stream u-offset of ubuf[0]
  size_t cursor = 0;
  bool hdr_done = false;
  std::vector<std::pair<std::string, int64_t>> refs;
  auto voff_at = [&](int64_t U) -> uint64_t {
    while (blocks.size() > 1 && blocks[1].first <= U) blocks.pop_front();
    if (blocks.empty()) return 0;
    return ((uint64_t)blocks.front().second << 16) |
           (uint64_t)(U - blocks.front().first);
  };
  for (;;) {
    int64_t bcoff = 0;
    int us = sc.next(blk, &bcoff);
    if (us == -1) break;
    if (us < -1) return -3;
    if (us > 0) {
      blocks.emplace_back(u_base + (int64_t)ubuf.size(), bcoff);
      ubuf.insert(ubuf.end(), blk.begin(), blk.begin() + us);
    }
    if (!hdr_done) {
      size_t hs = 0;
      int r = try_parse_bam_header(ubuf.data(), ubuf.size(), refs, &hs);
      if (r < 0) return -2;
      if (r == 0) continue;
      hdr_done = true;
      cursor = hs;
      if (refs_out) *refs_out = std::move(refs);
    }
    for (;;) {
      if (ubuf.size() - cursor < 4) break;
      uint32_t bs = rd_u32(ubuf.data() + cursor);
      if (bs < 32 || bs > (1u << 30)) return -2;
      if (ubuf.size() - cursor < 4 + (size_t)bs) break;
      uint64_t voff = voff_at(u_base + (int64_t)cursor);
      if (!cb(voff, ubuf.data() + cursor + 4)) {
        if (end_voff_out) *end_voff_out = voff;
        return 0;
      }
      cursor += 4 + bs;
    }
    if (cursor > (size_t)(1 << 23)) {  // compact the consumed prefix
      ubuf.erase(ubuf.begin(), ubuf.begin() + cursor);
      u_base += (int64_t)cursor;
      cursor = 0;
    }
  }
  if (!hdr_done) return -2;
  if (end_voff_out) *end_voff_out = voff_at(u_base + (int64_t)cursor);
  return 0;
}

// ASCII -> code (A0 C1 G2 T3 -4 N5 M6; else 4), mirrors SEQ_NUM (kmer.rs:11-22)
static uint8_t kAscii2Code[256];
// BAM 4-bit seq code -> our base code
static uint8_t kSeq4ToCode[16];
// BAM 4-bit seq code -> ASCII, and ASCII -> complement ASCII (identity except
// ATGC/atgc -> uppercase complement; mirrors utils/seqcodes.REVCOMP_ASCII,
// reference secondary.rs:66-80)
static uint8_t kSeq4AsciiT[16];
static uint8_t kRevCompAscii[256];
static bool kTablesInit = false;

static void init_tables() {
  if (kTablesInit) return;
  for (int i = 0; i < 256; i++) kAscii2Code[i] = 4;
  kAscii2Code['A'] = kAscii2Code['a'] = 0;
  kAscii2Code['C'] = kAscii2Code['c'] = 1;
  kAscii2Code['G'] = kAscii2Code['g'] = 2;
  kAscii2Code['T'] = kAscii2Code['t'] = 3;
  kAscii2Code['U'] = kAscii2Code['u'] = 3;
  kAscii2Code['N'] = kAscii2Code['n'] = 5;
  kAscii2Code['M'] = kAscii2Code['m'] = 6;
  kAscii2Code['-'] = 4;
  const char* seq4 = "=ACMGRSVTWYHKDBN";
  for (int i = 0; i < 16; i++) kSeq4ToCode[i] = kAscii2Code[(uint8_t)seq4[i]];
  for (int i = 0; i < 16; i++) kSeq4AsciiT[i] = (uint8_t)seq4[i];
  for (int i = 0; i < 256; i++) kRevCompAscii[i] = (uint8_t)i;
  const char* fwd = "ATGCatgc";
  const char* rev = "TACGTACG";
  for (int i = 0; i < 8; i++) kRevCompAscii[(uint8_t)fwd[i]] = (uint8_t)rev[i];
  kTablesInit = true;
}

struct BamRec {
  int32_t tid, pos;
  uint16_t flag;
  uint8_t mapq;
  const uint8_t* cigar;  // n_cigar u32 entries
  uint32_t n_cigar;
  const uint8_t* seq4;   // packed 4-bit
  int32_t l_seq;
};

// Parse the fixed prefix of a BAM record payload. `q` MUST point just past
// the record's block_size field (true for every caller: record pointers are
// collected from the contiguous raw-file walk) — the long-CIGAR path reads
// the block size back from q - 4 to bound the aux scan.
static inline void parse_rec(const uint8_t* q, BamRec& r) {
  r.tid = rd_i32(q);
  r.pos = rd_i32(q + 4);
  uint8_t l_rn = q[8];
  r.mapq = q[9];
  r.n_cigar = rd_u16(q + 12);
  r.flag = rd_u16(q + 14);
  r.l_seq = rd_i32(q + 16);
  r.cigar = q + 32 + l_rn;
  r.seq4 = r.cigar + 4 * r.n_cigar;
  // Long-CIGAR records: BAM stores n_cigar as u16, so >65535-op alignments
  // carry a placeholder "<l_seq>S <ref_len>N" CIGAR here with the real one
  // in the CG:B,I aux tag (htslib behavior behind rust-htslib's r.cigar(),
  // reference main.rs:1785). Detect the placeholder and point r.cigar at
  // the aux array — same u32 op encoding, zero copies.
  if (r.n_cigar == 2 && r.l_seq > 0) {
    uint32_t c0 = rd_u32(r.cigar), c1 = rd_u32(r.cigar + 4);
    if (c0 == (((uint32_t)r.l_seq << 4) | 4u) && (c1 & 0xF) == 3u) {
      const uint8_t* aux = r.seq4 + (r.l_seq + 1) / 2 + r.l_seq;
      const uint8_t* end = q + rd_i32(q - 4);
      while (aux + 4 <= end) {
        uint8_t t1 = aux[0], t2 = aux[1], typ = aux[2];
        aux += 3;
        if (typ == 'B') {
          if (aux + 5 > end) break;
          uint8_t sub = aux[0];
          uint32_t cnt = rd_u32(aux + 1);
          int esz = (sub == 'c' || sub == 'C') ? 1
                    : (sub == 's' || sub == 'S') ? 2 : 4;
          if (t1 == 'C' && t2 == 'G' && (sub == 'I' || sub == 'i') &&
              aux + 5 + (size_t)4 * cnt <= end) {
            r.cigar = aux + 5;
            r.n_cigar = cnt;
            break;
          }
          aux += 5 + (size_t)esz * cnt;
        } else if (typ == 'Z' || typ == 'H') {
          while (aux < end && *aux) aux++;
          aux++;
        } else {
          aux += (typ == 'A' || typ == 'c' || typ == 'C') ? 1
                 : (typ == 's' || typ == 'S') ? 2 : 4;  // i/I/f
        }
      }
    }
  }
}

struct Filters {
  const uint8_t* tseq_codes;
  int64_t tlen;
  int64_t min_map_qual, min_read_len, min_map_len;
  double min_map_fra;
  int64_t max_clip_len, use_secondary, use_supplementary;
  int trim_len;
  int64_t short_ref_len;
};

struct BamFile {
  // legacy whole-file path (non-BGZF plain-gzip inputs only; unbounded RAM)
  Bytes raw;
  size_t rec_off = 0;  // offset of first record in raw
  // BGZF indexed path (the default): compressed file on disk + per-contig
  // decompressed window; see the "BGZF random access" section above.
  int fd = -1;
  int64_t fsize = 0;
  bool bgzf = false;
  std::vector<uint64_t> tid_vbeg, tid_vend;  // [n_ref]; vbeg==vend -> empty
  Bytes cur;            // current contig's decompressed record window
  int64_t cur_lo = 0;   // first valid byte in cur
  int64_t cur_hi = 0;   // one past the last valid byte
  std::vector<std::pair<std::string, int64_t>> refs;
  ~BamFile() { if (fd >= 0) ::close(fd); }
  // v3 metadata from np2_extract_begin3 (small; per-kept-record only)
  std::vector<const uint8_t*> v3_recs;   // kept record payloads
  std::vector<int64_t> v3_off;           // stream offset per kept record
  std::vector<int64_t> v3_bounds;        // aln_t_s, aln_t_e per kept record
  std::vector<uint8_t> v3_clip;
  int64_t v3_total = 0;
  Filters v3_f{};
  // -S support: qname -> primary SEQ normalized to forward orientation
  // (ASCII; mirrors io/bam.retrieve_secondary_seqs, secondary.rs:8-64,82-148).
  // SHARED per path across the handle pool: the two full-file prefetch
  // passes and the resident SEQ map are paid once per BAM, not once per
  // pooled handle (matches the reference's single shared map,
  // main.rs:1691-1696).
  struct SecShared {
    std::mutex mu;
    bool done = false;
    std::unordered_map<std::string, std::vector<uint8_t>> seqs;
  };
  std::shared_ptr<SecShared> sec;
};

// per-path registry of the shared -S maps (np2_open attaches; entries live
// for the process — the maps themselves are built lazily and only under -S)
static std::mutex g_sec_mu;
static std::unordered_map<std::string, std::shared_ptr<BamFile::SecShared>>
    g_sec_reg;

static std::shared_ptr<BamFile::SecShared> sec_shared_for(const char* path) {
  std::lock_guard<std::mutex> g(g_sec_mu);
  auto& sp = g_sec_reg[path];
  if (!sp) sp = std::make_shared<BamFile::SecShared>();
  return sp;
}

static bool parse_bam_header(BamFile& bf) {
  const uint8_t* p = bf.raw.d.data();
  size_t n = bf.raw.d.size();
  if (n < 12 || memcmp(p, "BAM\x01", 4) != 0) return false;
  uint32_t l_text = rd_u32(p + 4);
  size_t off = 8 + l_text;
  if (off + 4 > n) return false;
  int32_t n_ref = rd_i32(p + off); off += 4;
  for (int32_t i = 0; i < n_ref; i++) {
    uint32_t l_name = rd_u32(p + off); off += 4;
    std::string name((const char*)p + off, l_name - 1); off += l_name;
    int32_t l_ref = rd_i32(p + off); off += 4;
    bf.refs.emplace_back(name, l_ref);
  }
  bf.rec_off = off;
  return true;
}

// ---------- contig index: .bai / .np2idx / streaming scan ----------

static bool read_whole_file(const char* path, std::vector<uint8_t>& out) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return false;
  struct stat st;
  if (fstat(fd, &st) != 0) { ::close(fd); return false; }
  out.resize((size_t)st.st_size);
  bool ok = file_pread(fd, out.data(), st.st_size, 0) == st.st_size;
  ::close(fd);
  return ok;
}

// Parse a BAI index (SAMv1 spec §5.2) into whole-contig virtual-offset
// ranges: prefer the samtools pseudo-bin 37450 (its first chunk is exactly
// (off_beg, off_end) for the ref); otherwise min/max over the regular bins'
// chunks. Mirrors what rust-htslib's IndexedReader::fetch consumes
// (main.rs:1741-1745). Returns false on malformed input or n_ref mismatch.
static bool load_bai(const char* path, size_t n_ref,
                     std::vector<uint64_t>& vbeg, std::vector<uint64_t>& vend) {
  std::vector<uint8_t> d;
  if (!read_whole_file(path, d)) return false;
  if (d.size() < 8 || memcmp(d.data(), "BAI\x01", 4) != 0) return false;
  size_t off = 4;
  auto need = [&](size_t n) { return off + n <= d.size(); };
  if (!need(4)) return false;
  int32_t nr = rd_i32(d.data() + off); off += 4;
  if (nr < 0 || (size_t)nr != n_ref) return false;
  for (int32_t i = 0; i < nr; i++) {
    if (!need(4)) return false;
    int32_t n_bin = rd_i32(d.data() + off); off += 4;
    uint64_t mn = UINT64_MAX, mx = 0;
    bool pseudo = false;
    uint64_t pbeg = 0, pend = 0;
    for (int32_t b = 0; b < n_bin; b++) {
      if (!need(8)) return false;
      uint32_t bin = rd_u32(d.data() + off);
      int32_t n_chunk = rd_i32(d.data() + off + 4);
      off += 8;
      if (n_chunk < 0 || !need((size_t)n_chunk * 16)) return false;
      if (bin == 37450 && n_chunk == 2) {
        pseudo = true;
        pbeg = rd_u64(d.data() + off);
        pend = rd_u64(d.data() + off + 8);
      } else {
        for (int32_t c = 0; c < n_chunk; c++) {
          uint64_t cb = rd_u64(d.data() + off + (size_t)c * 16);
          uint64_t ce = rd_u64(d.data() + off + (size_t)c * 16 + 8);
          if (cb < mn) mn = cb;
          if (ce > mx) mx = ce;
        }
      }
      off += (size_t)n_chunk * 16;
    }
    if (!need(4)) return false;
    int32_t n_intv = rd_i32(d.data() + off); off += 4;
    if (n_intv < 0 || !need((size_t)n_intv * 8)) return false;
    off += (size_t)n_intv * 8;
    if (pseudo) { vbeg[(size_t)i] = pbeg; vend[(size_t)i] = pend; }
    else if (mn != UINT64_MAX) { vbeg[(size_t)i] = mn; vend[(size_t)i] = mx; }
  }
  return true;
}

// .np2idx sidecar cache: "NP2I\x01" + u64 bam size + u64 bam mtime (ns) +
// u32 n_ref + n_ref x (u64 vbeg, u64 vend). Built by the one-pass scan below
// so repeated opens of index-less BAMs skip the full-file decompress.
static bool load_np2idx(const char* path, int64_t bam_size, int64_t bam_mtime,
                        size_t n_ref, std::vector<uint64_t>& vbeg,
                        std::vector<uint64_t>& vend) {
  std::vector<uint8_t> d;
  if (!read_whole_file(path, d)) return false;
  size_t want = 5 + 8 + 8 + 4 + n_ref * 16;
  if (d.size() != want || memcmp(d.data(), "NP2I\x01", 5) != 0) return false;
  if ((int64_t)rd_u64(d.data() + 5) != bam_size ||
      (int64_t)rd_u64(d.data() + 13) != bam_mtime)
    return false;
  if (rd_u32(d.data() + 21) != (uint32_t)n_ref) return false;
  for (size_t i = 0; i < n_ref; i++) {
    vbeg[i] = rd_u64(d.data() + 25 + i * 16);
    vend[i] = rd_u64(d.data() + 25 + i * 16 + 8);
  }
  return true;
}

static void save_np2idx(const char* path, int64_t bam_size, int64_t bam_mtime,
                        const std::vector<uint64_t>& vbeg,
                        const std::vector<uint64_t>& vend) {
  std::string tmp = std::string(path) + ".tmp";
  FILE* f = fopen(tmp.c_str(), "wb");
  if (!f) return;  // read-only dir: silently skip the cache
  bool ok = fwrite("NP2I\x01", 1, 5, f) == 5;
  uint64_t u = (uint64_t)bam_size;
  ok = ok && fwrite(&u, 8, 1, f) == 1;
  u = (uint64_t)bam_mtime;
  ok = ok && fwrite(&u, 8, 1, f) == 1;
  uint32_t nr = (uint32_t)vbeg.size();
  ok = ok && fwrite(&nr, 4, 1, f) == 1;
  for (size_t i = 0; ok && i < vbeg.size(); i++) {
    ok = fwrite(&vbeg[i], 8, 1, f) == 1 && fwrite(&vend[i], 8, 1, f) == 1;
  }
  ok = (fclose(f) == 0) && ok;
  if (ok) rename(tmp.c_str(), path);
  else unlink(tmp.c_str());
}

// One-pass streaming linear index: per-tid [first record voff, one past the
// last]. Bounded memory (one rolling block window). Requires the coordinate
// sort the reference asserts too (main.rs:1753-1756): each tid's records must
// form one contiguous run. Returns 0, -4 if a tid run repeats (unsorted).
static int build_linear_index(BamFile& bf) {
  int n_ref = (int)bf.refs.size();
  std::vector<uint8_t> seen((size_t)n_ref, 0);
  int32_t prev_tid = -2;
  int err = 0;
  uint64_t end_voff = 0;
  int rc = bgzf_walk(
      bf.fd, bf.fsize, nullptr, &end_voff,
      [&](uint64_t voff, const uint8_t* q) {
        int32_t tid = rd_i32(q);
        if (tid != prev_tid) {
          if (prev_tid >= 0) bf.tid_vend[(size_t)prev_tid] = voff;
          if (tid >= 0) {
            if (tid >= n_ref || seen[(size_t)tid]) { err = -4; return false; }
            seen[(size_t)tid] = 1;
            bf.tid_vbeg[(size_t)tid] = voff;
          }
          prev_tid = tid;
        }
        return true;
      });
  if (err) return err;
  if (rc < 0) return rc;
  if (prev_tid >= 0) bf.tid_vend[(size_t)prev_tid] = end_voff;
  return 0;
}

static bool np2_idxcache_enabled() {
  const char* e = getenv("NP2_NO_IDXCACHE");
  return !(e && *e == '1');
}

// Resolve per-tid virtual-offset ranges for an open BGZF handle (see the
// section comment for the .bai -> .np2idx -> scan preference order).
static bool load_contig_index(BamFile& bf, const char* bam_path) {
  size_t n_ref = bf.refs.size();
  bf.tid_vbeg.assign(n_ref, 0);
  bf.tid_vend.assign(n_ref, 0);
  std::string p(bam_path);
  std::string bai = p + ".bai";
  struct stat st;
  if (stat(bai.c_str(), &st) != 0 && p.size() > 4 &&
      p.compare(p.size() - 4, 4, ".bam") == 0) {
    std::string alt = p.substr(0, p.size() - 4) + ".bai";
    if (stat(alt.c_str(), &st) == 0) bai = alt;
  }
  if (stat(bai.c_str(), &st) == 0 &&
      load_bai(bai.c_str(), n_ref, bf.tid_vbeg, bf.tid_vend))
    return true;
  struct stat bst;
  if (fstat(bf.fd, &bst) != 0) return false;
  int64_t mtime = (int64_t)bst.st_mtim.tv_sec * 1000000000 +
                  bst.st_mtim.tv_nsec;
  std::string idx = p + ".np2idx";
  if (np2_idxcache_enabled() &&
      load_np2idx(idx.c_str(), bst.st_size, mtime, n_ref, bf.tid_vbeg,
                  bf.tid_vend))
    return true;
  double t0 = np2_now();
  if (build_linear_index(bf) != 0) return false;
  NP2_T("open: index scan", t0);
  if (np2_idxcache_enabled())
    save_np2idx(idx.c_str(), bst.st_size, mtime, bf.tid_vbeg, bf.tid_vend);
  return true;
}

// Pread + inflate the contig's compressed block range into bf.cur (exact-size
// output, multi-threaded across blocks). Sets cur_lo/cur_hi to the record
// byte range within the window. Returns 0 or -3 on corrupt input.
static int fetch_region(BamFile& bf, uint64_t vbeg, uint64_t vend, int T) {
  Bytes().d.swap(bf.cur.d);  // actually release the previous window
  bf.cur_lo = bf.cur_hi = 0;
  if (vend <= vbeg) return 0;
  int64_t cbeg = (int64_t)(vbeg >> 16);
  int64_t ubeg = (int64_t)(vbeg & 0xFFFF);
  int64_t cend = (int64_t)(vend >> 16);
  int64_t uend = (int64_t)(vend & 0xFFFF);
  int64_t cstop;
  if (uend > 0) {
    uint8_t hdr[18];
    if (cend + 18 > bf.fsize || file_pread(bf.fd, hdr, 18, cend) != 18)
      return -3;
    int bs = bgzf_bsize(hdr, 18);
    if (bs < 0) return -3;
    cstop = cend + bs;
  } else {
    cstop = cend;
  }
  if (cstop > bf.fsize) cstop = bf.fsize;
  if (cstop <= cbeg) return 0;
  double t0 = np2_now();
  std::vector<uint8_t> cbuf((size_t)(cstop - cbeg));
  if (file_pread(bf.fd, cbuf.data(), cstop - cbeg, cbeg) != cstop - cbeg)
    return -3;
  NP2_T("fetch_region: pread", t0);
  t0 = np2_now();
  struct Blk { int64_t c, u; int bs, us; };
  std::vector<Blk> blks;
  int64_t c = 0, u = 0, u_at_cend = -1;
  int64_t clim = cstop - cbeg;
  while (c < clim) {
    int bs = bgzf_bsize(cbuf.data() + c, clim - c);
    if (bs < 0 || c + bs > clim) return -3;
    int us = (int)rd_u32(cbuf.data() + c + bs - 4);
    if (us < 0 || us > (1 << 20)) return -3;
    if (cbeg + c == cend) u_at_cend = u;
    blks.push_back({c, u, bs, us});
    c += bs;
    u += us;
  }
  bf.cur.d.resize((size_t)u);
  int nT = T < 1 ? 1 : (T > 16 ? 16 : T);
  if ((int64_t)blks.size() < 2 * nT) nT = 1;
  std::atomic<int> err(0);
  auto work = [&](int t) {
    Inflater inf;
    size_t lo = blks.size() * (size_t)t / (size_t)nT;
    size_t hi = blks.size() * (size_t)(t + 1) / (size_t)nT;
    for (size_t i = lo; i < hi; i++) {
      if (inf.block(cbuf.data() + blks[i].c, blks[i].bs,
                    bf.cur.d.data() + blks[i].u, blks[i].us) != blks[i].us) {
        err.store(1);
        return;
      }
    }
  };
  if (nT == 1) {
    work(0);
  } else {
    std::vector<std::thread> ths;
    for (int t = 0; t < nT; t++) ths.emplace_back(work, t);
    for (auto& th : ths) th.join();
  }
  if (err.load()) return -3;
  NP2_T("fetch_region: inflate", t0);
  bf.cur_lo = ubeg;
  bf.cur_hi = (uend > 0 && u_at_cend >= 0) ? u_at_cend + uend : u;
  if (bf.cur_hi > u) bf.cur_hi = u;
  if (bf.cur_lo > bf.cur_hi) return -3;
  return 0;
}

// ---------- alignment expansion ----------

// CIGAR ops: MIDNSHP=X
static inline bool consumes_ref(int op) {
  return op == 0 || op == 2 || op == 3 || op == 7 || op == 8;
}
static inline bool consumes_qry(int op) {
  return op == 0 || op == 1 || op == 4 || op == 7 || op == 8;
}

struct RecInfo {
  int64_t shift, new_len;      // surviving column range [shift, new_len)
  int64_t aln_t_s, aln_t_e;    // post-trim target bounds (inclusive)
  bool clip;
};

// Collect one primary record's SEQ into sec_seqs if its qname is wanted
// (ASCII, stored in forward/read orientation).
static void collect_primary_seq(
    std::unordered_map<std::string, std::vector<uint8_t>>& sec_seqs,
    const std::unordered_set<std::string>& ids, const uint8_t* q) {
  uint16_t flag = rd_u16(q + 14);
  if (flag & 0x900) return;  // only primaries donate SEQ
  uint8_t l_rn = q[8];
  std::string qn((const char*)q + 32, (size_t)l_rn - 1);
  if (!ids.count(qn) || sec_seqs.count(qn)) return;
  int32_t l_seq = rd_i32(q + 16);
  uint32_t n_cigar = rd_u16(q + 12);
  const uint8_t* seq4 = q + 32 + l_rn + 4 * n_cigar;
  std::vector<uint8_t> ascii((size_t)l_seq);
  for (int32_t i = 0; i < l_seq; i++) {
    uint8_t b = seq4[i >> 1];
    ascii[(size_t)i] = kSeq4AsciiT[(i & 1) ? (b & 0xF) : (b >> 4)];
  }
  if (flag & 0x10) {  // store forward-strand orientation
    std::vector<uint8_t> rc(ascii.size());
    for (size_t i = 0; i < ascii.size(); i++)
      rc[i] = kRevCompAscii[ascii[ascii.size() - 1 - i]];
    ascii.swap(rc);
  }
  sec_seqs.emplace(std::move(qn), std::move(ascii));
}

// Two passes over the whole BAM: collect the qnames of secondary records,
// then store their primaries' SEQ. Mirrors io/bam.retrieve_secondary_seqs /
// secondary.rs:8-64,82-148. On the BGZF path both passes stream blocks with
// bounded memory (only the wanted SEQs stay resident — same shape as the
// reference's shared sec_seqs map, main.rs:1691-1696).
static void prefetch_secondary(BamFile& bf) {
  auto sp = bf.sec;
  if (!sp) return;  // non-registry open (shouldn't happen) -> no -S subst
  std::lock_guard<std::mutex> g(sp->mu);
  if (sp->done) return;
  sp->done = true;
  auto& out = sp->seqs;
  std::unordered_set<std::string> ids;
  if (bf.bgzf) {
    bgzf_walk(bf.fd, bf.fsize, nullptr, nullptr,
              [&](uint64_t, const uint8_t* q) {
                if (rd_u16(q + 14) & 0x100)
                  ids.emplace((const char*)q + 32, (size_t)q[8] - 1);
                return true;
              });
    if (ids.empty()) return;
    bgzf_walk(bf.fd, bf.fsize, nullptr, nullptr,
              [&](uint64_t, const uint8_t* q) {
                collect_primary_seq(out, ids, q);
                return true;
              });
    return;
  }
  const uint8_t* p = bf.raw.d.data();
  size_t n = bf.raw.d.size();
  for (size_t off = bf.rec_off; off + 4 <= n;) {
    int32_t block = rd_i32(p + off); off += 4;
    if (off + (size_t)block > n) break;
    const uint8_t* q = p + off; off += block;
    if (rd_u16(q + 14) & 0x100)
      ids.emplace((const char*)q + 32, (size_t)q[8] - 1);
  }
  if (ids.empty()) return;
  for (size_t off = bf.rec_off; off + 4 <= n;) {
    int32_t block = rd_i32(p + off); off += 4;
    if (off + (size_t)block > n) break;
    const uint8_t* q = p + off; off += block;
    collect_primary_seq(out, ids, q);
  }
}

// Resolve the substituted SEQ for a secondary record (null for primaries or
// when -S is off). *err = -7 when the primary is missing from the BAM.
static const std::vector<uint8_t>* sub_for(const BamFile& bf, const uint8_t* q,
                                           uint16_t flag, int* err) {
  if (!(flag & 0x100) || !bf.v3_f.use_secondary) return nullptr;
  std::string qn((const char*)q + 32, (size_t)q[8] - 1);
  auto it = bf.sec->seqs.find(qn);
  if (it == bf.sec->seqs.end()) { *err = -7; return nullptr; }
  return &it->second;
}

// Filter + expand + trim one record into per-thread scratch code arrays.
// Returns true if the record survives every filter (incl. the short-ref clip
// drop). Mirrors the reference worker loop (main.rs:1751-1816), fill_with_cigar
// (main.rs:386-440) and trim (main.rs:446-513). `sub`: substituted SEQ for
// secondary records (-S), ASCII in forward orientation (main.rs:1775-1788).
static bool analyze_record(const BamRec& r, const Filters& f,
                           std::vector<uint8_t>& q_codes,
                           std::vector<uint8_t>& t_codes, RecInfo& out,
                           const std::vector<uint8_t>* sub = nullptr) {
  if (r.flag & 0x404) return false;
  if ((int64_t)r.mapq <= f.min_map_qual) return false;
  bool secondary = r.flag & 0x100, supplementary = r.flag & 0x800;
  if (secondary && !f.use_secondary) return false;
  if (supplementary && !f.use_supplementary) return false;

  // read length from cigar incl hard clips (main.rs:1758)
  int64_t rlen = 0, ref_span = 0, qlen = 0;
  for (uint32_t i = 0; i < r.n_cigar; i++) {
    uint32_t c = rd_u32(r.cigar + 4 * i);
    int op = c & 0xF; int64_t l = c >> 4;
    if (consumes_qry(op) || op == 5) rlen += l;
    if (consumes_qry(op)) qlen += l;
    if (consumes_ref(op)) ref_span += l;
  }
  if (rlen <= f.min_read_len) return false;
  int64_t mml = f.min_map_len;
  int64_t frac = (int64_t)((float)rlen * (float)f.min_map_fra);
  if (ref_span < (mml > frac ? mml : frac)) return false;

  // expand cigar into gapped code arrays (fill_with_cigar, main.rs:386-440)
  q_codes.clear();
  t_codes.clear();
  q_codes.reserve(rlen + 64);
  t_codes.reserve(rlen + 64);
  int64_t qs = 0, ts = r.pos;
  int64_t aln_q_s = 0, aln_q_e = 0;
  bool first = true;
  if (sub && (int64_t)sub->size() < qlen) return false;  // malformed input
  bool sub_rev = (r.flag & 0x10) != 0;
  auto qcode = [&](int64_t i) {
    if (sub) {
      uint8_t a = sub_rev ? kRevCompAscii[(*sub)[sub->size() - 1 - (size_t)i]]
                          : (*sub)[(size_t)i];
      return kAscii2Code[a];
    }
    uint8_t b = r.seq4[i >> 1];
    return kSeq4ToCode[(i & 1) ? (b & 0xF) : (b >> 4)];
  };
  for (uint32_t i = 0; i < r.n_cigar; i++) {
    uint32_t c = rd_u32(r.cigar + 4 * i);
    int op = c & 0xF; int64_t l = c >> 4;
    if (op == 4) {  // soft clip
      qs += l;
      if (first) aln_q_s = qs; else aln_q_e = qs - l;
    } else if (op == 0 || op == 7 || op == 8) {
      for (int64_t k = 0; k < l; k++) { q_codes.push_back(qcode(qs + k)); }
      for (int64_t k = 0; k < l; k++) { t_codes.push_back(f.tseq_codes[ts + k]); }
      qs += l; ts += l;
    } else if (op == 1) {
      for (int64_t k = 0; k < l; k++) { q_codes.push_back(qcode(qs + k)); }
      t_codes.insert(t_codes.end(), l, 4);
      qs += l;
    } else if (op == 2) {
      q_codes.insert(q_codes.end(), l, 4);
      for (int64_t k = 0; k < l; k++) { t_codes.push_back(f.tseq_codes[ts + k]); }
      ts += l;
    } else if (op == 5) {
      // hard clip: ignored
    } else {
      return false;  // N/P unsupported (reference panics, main.rs:430-432)
    }
    first = false;
  }
  if (aln_q_e == 0) aln_q_e = qs;
  int64_t aln_t_s = r.pos;

  bool is_clip = aln_q_e - aln_q_s + f.max_clip_len < rlen;
  if (is_clip && f.tlen < f.short_ref_len) return false;  // main.rs:1806-1810

  // trim to trim_len-match boundaries (main.rs:446-513)
  int64_t n = (int64_t)t_codes.size();
  int64_t shift = n, new_len = n;
  {
    int64_t j = 0;
    for (int64_t i = 0; i < n; i++) {
      if (t_codes[i] == q_codes[i]) { j++; if (j == f.trim_len) { shift = i + 1 - f.trim_len; break; } }
      else j = 0;
    }
    if (shift < n) {
      j = 0;
      for (int64_t i = n - 1; i >= 0; i--) {
        if (t_codes[i] == q_codes[i]) { j++; if (j == f.trim_len) { new_len = i + f.trim_len; break; } }
        else j = 0;
      }
      // aln_t_s advance = # t-consuming columns before shift
      for (int64_t i = 0; i < shift; i++) if (t_codes[i] != 4) aln_t_s++;
    }
  }
  if (shift >= n) return false;
  // aln_len uses the truncated length (reference truncates before the check)
  if ((new_len - shift) <= f.min_map_len) return false;

  // aln_t_e: last target position covered (first surviving column sits at
  // aln_t_s; every later non-gap column advances by one)
  int64_t adv = 0;
  for (int64_t i = shift + 1; i < new_len; i++) if (t_codes[i] != 4) adv++;

  out.shift = shift;
  out.new_len = new_len;
  out.aln_t_s = aln_t_s;
  out.aln_t_e = aln_t_s + adv;
  out.clip = is_clip;
  return true;
}

// Emit the (t_pos, packed 3-mer key) tag stream for one analyzed record
// directly into caller buffers at `off` (get_align_tag + update_msas semantics,
// main.rs:314-338, 576-589). Exactly new_len - shift entries.
static void emit_tags(const std::vector<uint8_t>& q_codes,
                      const std::vector<uint8_t>& t_codes,
                      const RecInfo& ri, int32_t* t_out, int32_t* k_out) {
  int64_t t_cur = ri.aln_t_s, delta = 0;
  int64_t b1_t = ri.aln_t_s - 1, b1_d = 0; uint32_t b1_q = 15;
  int64_t b2_t = ri.aln_t_s - 1, b2_d = 1; uint32_t b2_q = 15;
  bool first_col = true;
  int64_t o = 0;
  for (int64_t i = ri.shift; i < ri.new_len; i++, o++) {
    uint8_t tb = t_codes[i], qb = q_codes[i];
    if (first_col) { t_cur = ri.aln_t_s; delta = 0; first_col = false; }
    else if (tb == 4) { delta++; }
    else { delta = 0; t_cur++; }
    // kmer key: (b1.delta<<16)|(flags<<12)|(b1.q<<8)|(b2.q<<4)|b3.q
    // delta saturates at u16 so the >=2^14 overflow guard still fires
    uint32_t flags = ((b2_t == b1_t) ? 4u : 0u) | ((b2_t == t_cur) ? 1u : 0u);
    uint32_t b1d_sat = b1_d > 0xFFFF ? 0xFFFFu : (uint32_t)b1_d;
    uint32_t key = (b1d_sat << 16) | (flags << 12) | (b1_q << 8) |
                   (b2_q << 4) | (uint32_t)qb;
    t_out[o] = (int32_t)t_cur;
    k_out[o] = (int32_t)key;
    b1_t = b2_t; b1_d = b2_d; b1_q = b2_q;
    b2_t = t_cur; b2_d = delta; b2_q = qb;
  }
}

}  // namespace

extern "C" {

// Opaque handle. BGZF inputs (the standard BAM encoding) use indexed
// random access: only the compressed file stays on disk and one contig's
// decompressed window lives in RAM at a time. Plain-gzip inputs fall back
// to the legacy whole-file-resident path.
void* np2_open(const char* bam_path) {
  init_tables();
  BamFile* bf = new BamFile();
  bf->sec = sec_shared_for(bam_path);
  int fd = open(bam_path, O_RDONLY);
  struct stat st{};
  bool is_bgzf = false;
  if (fd >= 0 && fstat(fd, &st) == 0 && st.st_size >= 28) {
    uint8_t hdr[18];
    if (file_pread(fd, hdr, 18, 0) == 18 && bgzf_bsize(hdr, 18) > 0)
      is_bgzf = true;
  }
  if (!is_bgzf) {
    if (fd >= 0) ::close(fd);
    if (!inflate_file(bam_path, bf->raw) || !parse_bam_header(*bf)) {
      delete bf;
      return nullptr;
    }
    return bf;
  }
  bf->fd = fd;
  bf->fsize = st.st_size;
  bf->bgzf = true;
  // header only: the walk stops at the first record
  int rc = bgzf_walk(fd, st.st_size, &bf->refs, nullptr,
                     [](uint64_t, const uint8_t*) { return false; });
  if (rc < 0 || !load_contig_index(*bf, bam_path)) {
    delete bf;
    return nullptr;
  }
  return bf;
}

void np2_close(void* handle) {
  delete static_cast<BamFile*>(handle);
}

// Number of references and their lengths (for contig lookup without pysam).
// BGZF inputs stream only as far as the header; plain gzip inflates fully.
int np2_bam_refs(const char* bam_path, char* names_out, int64_t names_cap,
                 int64_t* lens_out, int64_t lens_cap, int64_t* n_refs) {
  init_tables();
  std::vector<std::pair<std::string, int64_t>> refs;
  int fd = open(bam_path, O_RDONLY);
  struct stat st{};
  bool streamed = false;
  if (fd >= 0 && fstat(fd, &st) == 0 && st.st_size >= 28) {
    uint8_t hdr[18];
    if (file_pread(fd, hdr, 18, 0) == 18 && bgzf_bsize(hdr, 18) > 0) {
      int rc = bgzf_walk(fd, st.st_size, &refs, nullptr,
                         [](uint64_t, const uint8_t*) { return false; });
      if (rc < 0) { ::close(fd); return -2; }
      streamed = true;
    }
  }
  if (fd >= 0) ::close(fd);
  if (!streamed) {
    BamFile bf;
    if (!inflate_file(bam_path, bf.raw)) return -1;
    if (!parse_bam_header(bf)) return -2;
    refs = std::move(bf.refs);
  }
  if ((int64_t)refs.size() > lens_cap) return 1;
  int64_t pos = 0;
  for (size_t i = 0; i < refs.size(); i++) {
    int64_t l = (int64_t)refs[i].first.size();
    if (pos + l + 1 > names_cap) return 1;
    memcpy(names_out + pos, refs[i].first.c_str(), l + 1);
    pos += l + 1;
    lens_out[i] = refs[i].second;
  }
  *n_refs = (int64_t)refs.size();
  return 0;
}

// ---------- v3 extraction: count, then fill caller buffers directly ----------

// Pass 1: locate + filter + trim + COUNT this contig's surviving records.
// Writes exact sizes; per-record metadata is staged in the handle (small).
// Returns 0, negative on error.
int np2_extract_begin3(void* handle, int32_t want_tid,
                       const uint8_t* tseq_codes, int64_t tlen,
                       int64_t min_map_qual, int64_t min_read_len,
                       int64_t min_map_len, double min_map_fra,
                       int64_t max_clip_len, int64_t use_secondary,
                       int64_t use_supplementary, int64_t trim_len,
                       int64_t short_ref_len, int64_t n_threads,
                       int64_t* stream_n, int64_t* reads_n) {
  init_tables();
  BamFile& bf = *static_cast<BamFile*>(handle);
  bf.v3_f = Filters{tseq_codes, tlen, min_map_qual, min_read_len, min_map_len,
                    min_map_fra, max_clip_len, use_secondary, use_supplementary,
                    (int)trim_len, short_ref_len};
  double t0 = np2_now();

  // locate this contig's records: BGZF path preads + inflates only the
  // contig's block range (indexed, bounded memory); the legacy plain-gzip
  // path scans the resident whole-file stream.
  std::vector<const uint8_t*> recs;
  std::vector<int64_t> est;  // cumulative l_seq for load balancing
  const uint8_t* p;
  size_t n, off;
  if (bf.bgzf) {
    if (want_tid < 0 || want_tid >= (int32_t)bf.refs.size()) return -6;
    int frc = fetch_region(bf, bf.tid_vbeg[(size_t)want_tid],
                           bf.tid_vend[(size_t)want_tid], (int)n_threads);
    if (frc != 0) return frc;
    p = bf.cur.d.data();
    n = (size_t)bf.cur_hi;
    off = (size_t)bf.cur_lo;
  } else {
    p = bf.raw.d.data();
    n = bf.raw.d.size();
    off = bf.rec_off;
  }
  int64_t prev_pos = -1, est_sum = 0;
  while (off + 4 <= n) {
    int32_t block = rd_i32(p + off); off += 4;
    if (off + (size_t)block > n) return -3;
    const uint8_t* q = p + off;
    off += block;
    int32_t tid = rd_i32(q);
    if (tid > want_tid) break;  // sorted: past our contig
    if (tid != want_tid) continue;
    int32_t pos = rd_i32(q + 4);
    if (pos < prev_pos) return -4;  // unsorted (main.rs:1753-1756)
    prev_pos = pos;
    recs.push_back(q);
    est_sum += rd_i32(q + 16) + 64;
    est.push_back(est_sum);
  }
  NP2_T("begin3: locate", t0);
  t0 = np2_now();

  int T = (int)(n_threads < 1 ? 1 : (n_threads > 16 ? 16 : n_threads));
  if ((int64_t)recs.size() < 4 * T) T = 1;
  // range split balanced by cumulative l_seq
  std::vector<size_t> bounds(T + 1, recs.size());
  bounds[0] = 0;
  for (int t = 1; t < T; t++) {
    int64_t want = est_sum / T * t;
    size_t lo = bounds[t - 1], hi = recs.size();
    while (lo < hi) { size_t m = (lo + hi) / 2; if (est[m] < want) lo = m + 1; else hi = m; }
    bounds[t] = lo;
  }

  if (bf.v3_f.use_secondary) prefetch_secondary(bf);  // read-only under threads

  // per-record results (indexed by located-record position; kept==false rows
  // are squeezed out after the parallel pass to preserve record order)
  std::vector<uint8_t> kept(recs.size(), 0);
  std::vector<RecInfo> info(recs.size());
  std::vector<int> aerr(T, 0);
  auto work = [&](int t) {
    std::vector<uint8_t> qs, ts;
    for (size_t i = bounds[t]; i < bounds[t + 1]; i++) {
      BamRec r;
      parse_rec(recs[i], r);
      int e = 0;
      const std::vector<uint8_t>* sub = sub_for(bf, recs[i], r.flag, &e);
      if (e) { aerr[t] = e; return; }
      RecInfo ri;
      if (analyze_record(r, bf.v3_f, qs, ts, ri, sub)) {
        kept[i] = 1;
        info[i] = ri;
      }
    }
  };
  if (T == 1) {
    work(0);
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < T; t++) threads.emplace_back(work, t);
    for (auto& th : threads) th.join();
  }
  for (int t = 0; t < T; t++) if (aerr[t]) return aerr[t];
  NP2_T("begin3: analyze", t0);

  bf.v3_recs.clear();
  bf.v3_off.clear();
  bf.v3_bounds.clear();
  bf.v3_clip.clear();
  int64_t total = 0;
  for (size_t i = 0; i < recs.size(); i++) {
    if (!kept[i]) continue;
    bf.v3_recs.push_back(recs[i]);
    bf.v3_off.push_back(total);
    bf.v3_bounds.push_back(info[i].aln_t_s);
    bf.v3_bounds.push_back(info[i].aln_t_e);
    bf.v3_clip.push_back(info[i].clip ? 1 : 0);
    total += info[i].new_len - info[i].shift;
  }
  bf.v3_total = total;
  *stream_n = total;
  *reads_n = (int64_t)bf.v3_recs.size();
  return 0;
}

// Pass 2: re-expand the kept records and emit tag streams directly into the
// caller's exact-size buffers (no staging copies).
int np2_extract_fetch3(void* handle, int32_t* t_pos_out, int32_t* key_out,
                       int64_t* read_start_out, int64_t* aln_bounds_out,
                       uint8_t* clip_flag_out, int64_t n_threads) {
  BamFile& bf = *static_cast<BamFile*>(handle);
  double t0 = np2_now();
  int64_t nr = (int64_t)bf.v3_recs.size();
  memcpy(read_start_out, bf.v3_off.data(), (size_t)nr * 8);
  memcpy(aln_bounds_out, bf.v3_bounds.data(), (size_t)nr * 16);
  memcpy(clip_flag_out, bf.v3_clip.data(), (size_t)nr);

  int T = (int)(n_threads < 1 ? 1 : (n_threads > 16 ? 16 : n_threads));
  if (nr < 4 * T) T = 1;
  // split on stream offsets for balance
  std::vector<int64_t> tb(T + 1, nr);
  tb[0] = 0;
  for (int t = 1; t < T; t++) {
    int64_t want = bf.v3_total / T * t;
    int64_t lo = tb[t - 1], hi = nr;
    while (lo < hi) { int64_t m = (lo + hi) / 2; if (bf.v3_off[m] < want) lo = m + 1; else hi = m; }
    tb[t] = lo;
  }
  std::vector<int> err(T, 0);
  auto work = [&](int t) {
    std::vector<uint8_t> qs, ts;
    for (int64_t i = tb[t]; i < tb[t + 1]; i++) {
      BamRec r;
      parse_rec(bf.v3_recs[i], r);
      int e = 0;
      const std::vector<uint8_t>* sub = sub_for(bf, bf.v3_recs[i], r.flag, &e);
      if (e) { err[t] = e; return; }
      RecInfo ri;
      if (!analyze_record(r, bf.v3_f, qs, ts, ri, sub)) { err[t] = -5; return; }
      emit_tags(qs, ts, ri, t_pos_out + bf.v3_off[i], key_out + bf.v3_off[i]);
    }
  };
  if (T == 1) {
    work(0);
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < T; t++) threads.emplace_back(work, t);
    for (auto& th : threads) th.join();
  }
  NP2_T("fetch3: emit", t0);
  bf.v3_recs.clear();
  bf.v3_off.clear();
  bf.v3_bounds.clear();
  bf.v3_clip.clear();
  if (bf.bgzf) {  // release this contig's decompressed window
    Bytes().d.swap(bf.cur.d);
    bf.cur_lo = bf.cur_hi = 0;
  }
  for (int t = 0; t < T; t++) if (err[t]) return err[t];
  return 0;
}

// ---------- stream sort + aggregation ----------

// Stable counting-sort of the (t_pos, key[, rid]) stream by t_pos.
// O(n + n_pos); replaces numpy's stable argsort (the round-1 plan_windows
// bottleneck at Mb scale). Also returns max(key>>16) for the delta-overflow
// guard (build_window_batch).
//
// Run mask (aoff/drop/nr, aoff nullable): entries live in per-alignseq runs
// [aoff[r], aoff[r+1]); drop[r] != 0 excludes run r entirely. The stable
// sort of the kept subsequence is BY CONSTRUCTION identical to filtering the
// stable sort of the full stream — the production path exploits that to sort
// straight off the resident flat ingest stream with the iteration's
// cumulative drop mask fused in, carrying NO rid plane and making NO filter
// copies (the old rid_in/rid_out/filter buffers were 16+ B/entry of pure
// sort-time working set the prefault had to provision). rid/rid_out are
// nullable; the masked production path passes null.
//
// Two-level stable bucket sort (large-n strategy): the one-level counting
// sort's scatter does one random DRAM write per entry across a ~GB output
// span — latency-bound at ~600-700 MB/s on these VMs. Level 1 scatters
// entries to ~16k-entry position BUCKETS (the cursor set fits cache, writes
// are near-sequential per bucket); level 2 counting-sorts each bucket through
// a thread-local staging buffer (everything cache-hot) and writes the final
// segment SEQUENTIALLY. Stability: level 1 is one in-order pass, level 2 is a
// stable counting sort per bucket. Level 2 threads by bucket range (disjoint
// output segments, no atomics). Returns kept entry count, or -1 on a
// t_pos out of [0, n_pos).
static int64_t sort_stream_bucketed(const int32_t* t_pos, const int32_t* key,
                                    const int32_t* rid,
                                    const int64_t* aoff, const uint8_t* drop,
                                    int64_t nr, int64_t n, int64_t n_pos,
                                    int32_t* t_out, int32_t* k_out,
                                    int32_t* rid_out, int64_t* max_b1d,
                                    int T) {
  int shift = 0;
  while ((n_pos >> shift) > (n >> 14) + 1) shift++;   // avg ~16k entries/bucket
  const int64_t NB = ((n_pos - 1) >> shift) + 1;
  const int64_t SPAN = (int64_t)1 << shift;
  const bool has_rid = rid != nullptr && rid_out != nullptr;
  std::vector<int64_t> bcnt(NB + 1, 0);
  int64_t mb = 0, n_kept = 0;
  // pass 1: bucket histogram + max delta over KEPT entries
  auto count_range = [&](int64_t lo, int64_t hi) -> int {
    for (int64_t i = lo; i < hi; i++) {
      int64_t tp = t_pos[i];
      if (tp < 0 || tp >= n_pos) return -1;
      bcnt[(tp >> shift) + 1]++;
      int64_t d = (int64_t)(((uint32_t)key[i]) >> 16);
      if (d > mb) mb = d;
    }
    n_kept += hi - lo;
    return 0;
  };
  if (aoff) {
    for (int64_t r = 0; r < nr; r++)
      if (!drop[r] && count_range(aoff[r], aoff[r + 1])) return -1;
  } else {
    if (count_range(0, n)) return -1;
  }
  *max_b1d = mb;
  for (int64_t b = 0; b < NB; b++) bcnt[b + 1] += bcnt[b];
  // level 1: stable scatter into bucket segments of the OUTPUT arrays
  {
    std::vector<int64_t> cur(bcnt.begin(), bcnt.end() - 1);
    auto scat_range = [&](int64_t lo, int64_t hi) {
      if (has_rid) {
        for (int64_t i = lo; i < hi; i++) {
          int64_t p = cur[t_pos[i] >> shift]++;
          t_out[p] = t_pos[i];
          k_out[p] = key[i];
          rid_out[p] = rid[i];
        }
      } else {
        for (int64_t i = lo; i < hi; i++) {
          int64_t p = cur[t_pos[i] >> shift]++;
          t_out[p] = t_pos[i];
          k_out[p] = key[i];
        }
      }
    };
    if (aoff) {
      for (int64_t r = 0; r < nr; r++)
        if (!drop[r]) scat_range(aoff[r], aoff[r + 1]);
    } else {
      scat_range(0, n);
    }
  }
  // level 2: stable counting sort of each bucket via thread-local staging
  auto work = [&](int t) {
    std::vector<int32_t> sk, sr;
    std::vector<int64_t> hist(SPAN + 1), cur(SPAN);
    int64_t b0 = NB / T * t, b1 = (t == T - 1) ? NB : NB / T * (t + 1);
    for (int64_t b = b0; b < b1; b++) {
      int64_t lo = bcnt[b], hi = bcnt[b + 1], m = hi - lo;
      if (m <= 1) continue;
      const int64_t base = b << shift;
      std::fill(hist.begin(), hist.begin() + SPAN + 1, 0);
      for (int64_t i = lo; i < hi; i++) hist[(t_out[i] - base) + 1]++;
      for (int64_t p = 0; p < SPAN; p++) hist[p + 1] += hist[p];
      sk.assign(k_out + lo, k_out + hi);
      if (has_rid) sr.assign(rid_out + lo, rid_out + hi);
      std::copy(hist.begin(), hist.begin() + SPAN, cur.begin());
      for (int64_t i = 0; i < m; i++) {
        int64_t rel = t_out[lo + i] - base;
        int64_t p = lo + cur[rel]++;
        // t_out rewritten from the histogram below; only payloads scatter
        k_out[p] = sk[i];
        if (has_rid) rid_out[p] = sr[i];
      }
      for (int64_t p = 0; p < SPAN; p++) {
        int32_t tv = (int32_t)(base + p);
        for (int64_t i = lo + hist[p]; i < lo + hist[p + 1]; i++) t_out[i] = tv;
      }
    }
  };
  if (T == 1) {
    work(0);
  } else {
    std::vector<std::thread> ths;
    for (int t = 0; t < T; t++) ths.emplace_back(work, t);
    for (auto& th : ths) th.join();
  }
  return n_kept;
}

// One-level counting sort (small-n strategy; single-threaded — the threaded
// scatter variant measured 15x SLOWER on this VM, round-2 note). Same run
// mask / nullable-rid contract as sort_stream_bucketed. t_out is filled
// SEQUENTIALLY from the histogram (bucket p = p repeated) — drops a third of
// the scatter's random-write traffic (the sort is memory-bound).
static int64_t sort_stream_onelevel(const int32_t* t_pos, const int32_t* key,
                                    const int32_t* rid,
                                    const int64_t* aoff, const uint8_t* drop,
                                    int64_t nr, int64_t n, int64_t n_pos,
                                    int32_t* t_out, int32_t* k_out,
                                    int32_t* rid_out, int64_t* max_b1d) {
  const bool has_rid = rid != nullptr && rid_out != nullptr;
  std::vector<int64_t> hist(n_pos + 1, 0);
  int64_t mb = 0, n_kept = 0;
  auto count_range = [&](int64_t lo, int64_t hi) -> int {
    for (int64_t i = lo; i < hi; i++) {
      int64_t tp = t_pos[i];
      if (tp < 0 || tp >= n_pos) return -1;
      hist[tp + 1]++;
      int64_t d = (int64_t)(((uint32_t)key[i]) >> 16);
      if (d > mb) mb = d;
    }
    n_kept += hi - lo;
    return 0;
  };
  if (aoff) {
    for (int64_t r = 0; r < nr; r++)
      if (!drop[r] && count_range(aoff[r], aoff[r + 1])) return -1;
  } else {
    if (count_range(0, n)) return -1;
  }
  *max_b1d = mb;
  for (int64_t p = 0; p < n_pos; p++) hist[p + 1] += hist[p];
  for (int64_t p = 0; p < n_pos; p++)
    std::fill(t_out + hist[p], t_out + hist[p + 1], (int32_t)p);
  std::vector<int64_t> cur(hist.begin(), hist.begin() + n_pos);
  auto scat_range = [&](int64_t lo, int64_t hi) {
    if (has_rid) {
      for (int64_t i = lo; i < hi; i++) {
        int64_t p = cur[t_pos[i]]++;
        k_out[p] = key[i];
        rid_out[p] = rid[i];
      }
    } else {
      for (int64_t i = lo; i < hi; i++) {
        int64_t p = cur[t_pos[i]]++;
        k_out[p] = key[i];
      }
    }
  };
  if (aoff) {
    for (int64_t r = 0; r < nr; r++)
      if (!drop[r]) scat_range(aoff[r], aoff[r + 1]);
  } else {
    scat_range(0, n);
  }
  return n_kept;
}

static int64_t sort_stream_core(const int32_t* t_pos, const int32_t* key,
                                const int32_t* rid,
                                const int64_t* aoff, const uint8_t* drop,
                                int64_t nr, int64_t n, int64_t n_pos,
                                int32_t* t_out, int32_t* k_out,
                                int32_t* rid_out, int64_t* max_b1d,
                                int64_t n_threads) {
  int T = (int)(n_threads < 1 ? 1 : (n_threads > 16 ? 16 : n_threads));
  const char* env = getenv("NP2_SORT_BUCKETED");
  bool bucketed = !(env && env[0] == '0');
  if (bucketed && n >= ((int64_t)1 << 22) && n_pos >= (1 << 16))
    return sort_stream_bucketed(t_pos, key, rid, aoff, drop, nr, n, n_pos,
                                t_out, k_out, rid_out, max_b1d, T);
  return sort_stream_onelevel(t_pos, key, rid, aoff, drop, nr, n, n_pos,
                              t_out, k_out, rid_out, max_b1d);
}

int np2_sort_stream(const int32_t* t_pos, const int32_t* key,
                    const int32_t* rid, int64_t n, int64_t n_pos,
                    int32_t* t_out, int32_t* k_out, int32_t* rid_out,
                    int64_t* max_b1d, int64_t n_threads) {
  int64_t r = sort_stream_core(t_pos, key, rid, nullptr, nullptr, 0, n,
                               n_pos, t_out, k_out, rid_out, max_b1d,
                               n_threads);
  return r < 0 ? -1 : 0;
}

// Fused drop-filter + stable sort off the flat per-alignseq run stream:
// sorts only kept runs' entries into t_out/k_out (capacity >= kept count;
// full n is always enough), no rid plane anywhere. Returns the kept entry
// count, or -1 on a t_pos out of range. max_b1d is the max key>>16 over
// KEPT entries only (the overflow guard must not trip on a dropped read's
// pathological insertion run).
int64_t np2_sort_stream_runs(const int32_t* t_pos, const int32_t* key,
                             const int64_t* aoff, const uint8_t* drop,
                             int64_t nr, int64_t n, int64_t n_pos,
                             int32_t* t_out, int32_t* k_out,
                             int64_t* max_b1d, int64_t n_threads) {
  return sort_stream_core(t_pos, key, nullptr, aoff, drop, nr, n, n_pos,
                          t_out, k_out, nullptr, max_b1d, n_threads);
}

// Anchor sweep straight off the t-sorted stream (find_anchors_stream
// semantics, pipeline/windows.py): colcnt[t] = entries at column t;
// matchcnt[t] = entries with b3-delta == 0 (key flags bit0 clear) and b3 ==
// ref_codes[t]; anchors[t] = columns t-2..t all pure (colcnt >= 2 and
// matchcnt == colcnt) with no alignment start at t-1 / t. Threaded over
// stream ranges split at position-run boundaries (disjoint columns per
// thread, no atomics).
int np2_find_anchors(const int32_t* t_sorted, const int32_t* k_sorted,
                     int64_t n, int64_t n_pos, const uint8_t* ref_codes,
                     const int64_t* startcnt, uint8_t* anchors_out,
                     int64_t* colcnt_out, int64_t n_threads) {
  std::fill(colcnt_out, colcnt_out + n_pos, 0);
  std::fill(anchors_out, anchors_out + n_pos, 0);
  std::vector<int64_t> matchcnt(n_pos, 0);
  int T = (int)(n_threads < 1 ? 1 : (n_threads > 16 ? 16 : n_threads));
  if (n < (int64_t)1 << 20) T = 1;
  std::vector<int64_t> b(T + 1, n);
  b[0] = 0;
  for (int t = 1; t < T; t++) {
    int64_t i = std::max(n / T * t, b[t - 1]);
    while (i < n && i > 0 && t_sorted[i] == t_sorted[i - 1]) i++;
    b[t] = i;
  }
  std::vector<int> errs(T, 0);
  auto work = [&](int t) {
    for (int64_t i = b[t]; i < b[t + 1]; i++) {
      int64_t tp = t_sorted[i];
      if (tp < 0 || tp >= n_pos) { errs[t] = -1; return; }
      colcnt_out[tp]++;
      uint32_t k = (uint32_t)k_sorted[i];
      if (!(k & 0x1000u) && (k & 0xFu) == ref_codes[tp]) matchcnt[tp]++;
    }
  };
  if (T == 1) {
    work(0);
  } else {
    std::vector<std::thread> ths;
    for (int t = 0; t < T; t++) ths.emplace_back(work, t);
    for (auto& th : ths) th.join();
  }
  for (int t = 0; t < T; t++) if (errs[t]) return errs[t];
  uint8_t p0 = 0, p1 = 0;  // pure[t-1], pure[t-2]
  for (int64_t t = 0; t < n_pos; t++) {
    uint8_t pure = (colcnt_out[t] >= 2 && matchcnt[t] == colcnt_out[t]) ? 1 : 0;
    if (t >= 2 && pure && p0 && p1 && startcnt[t] == 0 && startcnt[t - 1] == 0)
      anchors_out[t] = 1;
    p1 = p0;
    p0 = pure;
  }
  return 0;
}

// Anchor sweep over the UNSORTED flat run stream (segmented lookahead:
// anchors are order-independent per-column aggregates, so they do not need
// the sorted stream — computing them here lets the window plan, and with
// it the next segment's cut, land BEFORE the sort finishes, taking the
// sort off the segmented critical path). Exactly np2_find_anchors'
// counts/epilogue over the drop-filtered entries; runs are per-read so t
// advances near-sequentially (cache-friendly). Single-threaded: the run
// pass streams at memory speed and sits under the scan in the pipeline.
int np2_find_anchors_runs(const int32_t* t_flat, const int32_t* k_flat,
                          const int64_t* aoff, const uint8_t* drop,
                          int64_t nr, int64_t n, int64_t n_pos,
                          const uint8_t* ref_codes, const int64_t* startcnt,
                          uint8_t* anchors_out, int64_t* colcnt_out) {
  std::fill(colcnt_out, colcnt_out + n_pos, 0);
  std::fill(anchors_out, anchors_out + n_pos, 0);
  std::vector<int64_t> matchcnt((size_t)n_pos, 0);
  for (int64_t r = 0; r < nr; r++) {
    if (drop[r]) continue;
    int64_t lo = aoff[r], hi = aoff[r + 1];
    if (lo < 0 || hi < lo || hi > n) return -1;
    for (int64_t i = lo; i < hi; i++) {
      int64_t tp = t_flat[i];
      if (tp < 0 || tp >= n_pos) return -1;
      colcnt_out[tp]++;
      uint32_t k = (uint32_t)k_flat[i];
      if (!(k & 0x1000u) && (k & 0xFu) == (uint32_t)ref_codes[tp])
        matchcnt[tp]++;
    }
  }
  uint8_t p0 = 0, p1 = 0;  // pure[t-1], pure[t-2]
  for (int64_t t = 0; t < n_pos; t++) {
    uint8_t pure =
        (colcnt_out[t] >= 2 && matchcnt[t] == colcnt_out[t]) ? 1 : 0;
    if (t >= 2 && pure && p0 && p1 && startcnt[t] == 0 && startcnt[t - 1] == 0)
      anchors_out[t] = 1;
    p1 = p0;
    p0 = pure;
  }
  return 0;
}

// Filter the sorted stream by a per-read drop mask (phasing iteration 2):
// keeps entries whose rid is not dropped, preserving order. Returns the kept
// count (>= 0) or a negative error. Threaded two-pass (count, prefix, fill).
// kept_maxd (nullable): max(key >> 16) over KEPT entries — the delta-
// overflow guard must be taken over the stream the DP will actually see;
// the flat_all ingest path's unfiltered stream includes clip-dropped reads
// whose deltas must not force a whole-contig oracle fallback.
int64_t np2_filter_stream(const int32_t* t_sorted, const int32_t* k_sorted,
                          const int32_t* rid_sorted, int64_t n,
                          const uint8_t* drop, int64_t n_reads,
                          int32_t* t_out, int32_t* k_out, int64_t n_threads,
                          int64_t* kept_maxd) {
  int T = (int)(n_threads < 1 ? 1 : (n_threads > 16 ? 16 : n_threads));
  if (n < (int64_t)1 << 20) T = 1;
  std::vector<int64_t> kept(T, 0);
  std::vector<int> errs(T, 0);
  auto seg = [&](int t) { return n / T * t; };
  auto count = [&](int t) {
    int64_t lo = seg(t), hi = (t == T - 1) ? n : seg(t + 1), c = 0;
    for (int64_t i = lo; i < hi; i++) {
      int64_t r = rid_sorted[i];
      if (r < 0 || r >= n_reads) { errs[t] = -1; return; }
      c += drop[r] ? 0 : 1;
    }
    kept[t] = c;
  };
  auto run = [&](auto fn) {
    if (T == 1) { fn(0); return; }
    std::vector<std::thread> ths;
    for (int t = 0; t < T; t++) ths.emplace_back(fn, t);
    for (auto& th : ths) th.join();
  };
  run(count);
  for (int t = 0; t < T; t++) if (errs[t]) return errs[t];
  std::vector<int64_t> off(T, 0);
  for (int t = 1; t < T; t++) off[t] = off[t - 1] + kept[t - 1];
  int64_t total = off[T - 1] + kept[T - 1];
  // IN-PLACE mode (t_out == t_sorted): forward compaction is safe
  // sequentially (write index p never passes read index i) but NOT per
  // thread segment — thread t's writes start at off[t] <= seg(t), inside
  // thread t-1's unread range. The count pass above stays threaded.
  bool aliased = (t_out == t_sorted) || (k_out == k_sorted);
  std::vector<int64_t> kmax(T, 0);
  auto fill = [&](int t) {
    int64_t lo = seg(t), hi = (t == T - 1) ? n : seg(t + 1), p = off[t];
    int64_t km = 0;
    for (int64_t i = lo; i < hi; i++) {
      if (!drop[rid_sorted[i]]) {
        t_out[p] = t_sorted[i];
        k_out[p] = k_sorted[i];
        int64_t d = (int64_t)(((uint32_t)k_sorted[i]) >> 16);
        if (d > km) km = d;
        p++;
      }
    }
    kmax[t] = km;
  };
  if (aliased) {
    int64_t p = 0, km = 0;
    for (int64_t i = 0; i < n; i++) {
      if (!drop[rid_sorted[i]]) {
        t_out[p] = t_sorted[i];
        k_out[p] = k_sorted[i];
        int64_t d = (int64_t)(((uint32_t)k_sorted[i]) >> 16);
        if (d > km) km = d;
        p++;
      }
    }
    kmax[0] = km;
  } else {
    run(fill);
  }
  if (kept_maxd) {
    int64_t km = 0;
    for (int t = 0; t < T; t++) if (kmax[t] > km) km = kmax[t];
    *kept_maxd = km;
  }
  return total;
}

namespace {
static inline int64_t b3d_of_key(int64_t key) {
  int64_t flags = (key >> 12) & 0xF;
  if ((flags & 0b0101) == 0b0101) return ((key >> 16) & 0xFFFF) + 2;
  return (flags & 1) ? 1 : 0;
}
}  // namespace

// Pileup aggregation for one device chunk, straight off the t-sorted global
// stream (no flat window-major copy): window w (relative row w) reads entries
// [lo[w], hi[w]) with col = t - lead[w]. Within a column the stream order is
// first-occurrence order; slots are stable-sorted by b3-delta on top — the
// reference slot order (Msa::push + Msa::sort, main.rs:193-229). Outputs:
// key_tab/cnt_tab i32[B*W*K], coverage/n_slots i32[B*W], overflow u8[B],
// all initialized here. lo/hi/lead are the chunk's own [nw] arrays; rows
// nw..B-1 stay empty.
int np2_aggregate3(const int32_t* t_sorted, const int32_t* k_sorted,
                   const int64_t* lo, const int64_t* hi, const int64_t* lead,
                   int64_t nw, int64_t B, int64_t W, int64_t K,
                   int64_t n_threads,
                   int32_t* key_tab, int32_t* cnt_tab,
                   int32_t* coverage, int32_t* n_slots, uint8_t* overflow) {
  std::fill(key_tab, key_tab + B * W * K, -1);
  std::fill(cnt_tab, cnt_tab + B * W * K, 0);
  std::fill(coverage, coverage + B * W, 0);
  std::fill(n_slots, n_slots + B * W, 0);
  std::fill(overflow, overflow + B, 0);
  if (nw > B) return -2;

  int T = (int)(n_threads < 1 ? 1 : (n_threads > 16 ? 16 : n_threads));
  int64_t total = 0;
  for (int64_t w = 0; w < nw; w++) total += hi[w] - lo[w];
  if (total < (int64_t)1 << 16) T = 1;
  // split windows by entry mass
  std::vector<int64_t> wb(T + 1, nw);
  wb[0] = 0;
  {
    int64_t acc = 0, t = 1;
    for (int64_t w = 0; w < nw && t < T; w++) {
      acc += hi[w] - lo[w];
      while (t < T && acc >= total / T * t) { wb[t] = w + 1; t++; }
    }
  }
  for (int t = 1; t < T; t++) if (wb[t] < wb[t - 1]) wb[t] = wb[t - 1];
  std::atomic<int> agg_err(0);

  auto work = [&](int t) {
    struct Seg { int64_t key, count, b3d; };
    std::vector<Seg> segs;
    segs.reserve(256);
    // open-address hash: key -> seg index, generation-tagged. CAP bounds the
    // distinct keys per column: structural-variant pileups can carry
    // thousands (7k slots seen on the bundled contig); past CAP the window is
    // flagged overflow (-> exact host fallback, host_fallback.py) and the
    // column scan skips ahead, keeping the probe loop terminating (load < 1).
    const int HB = 13, HN = 1 << HB;
    const int64_t CAP = HN / 2;
    std::vector<int32_t> hkey(HN);
    std::vector<int32_t> hseg(HN);
    std::vector<uint32_t> hgen(HN, 0);
    uint32_t gen = 0;
    for (int64_t w = wb[t]; w < wb[t + 1]; w++) {
      int64_t i = lo[w], end = hi[w];
      int64_t ld = lead[w];
      while (i < end) {
        int32_t tp = t_sorted[i];
        int64_t col = (int64_t)tp - ld;
        segs.clear();
        gen++;
        bool full = false;
        int64_t j = i;
        for (; j < end && t_sorted[j] == tp; j++) {
          int32_t k = k_sorted[j];
          uint32_t h = ((uint32_t)k * 2654435761u) >> (32 - HB);
          for (;;) {
            if (hgen[h] != gen) {
              if ((int64_t)segs.size() >= CAP) { full = true; break; }
              hgen[h] = gen;
              hkey[h] = k;
              hseg[h] = (int32_t)segs.size();
              segs.push_back({(int64_t)(uint32_t)k, 1, b3d_of_key((int64_t)(uint32_t)k)});
              break;
            }
            if (hkey[h] == k) { segs[hseg[h]].count++; break; }
            h = (h + 1) & (HN - 1);
          }
          if (full) break;
        }
        if (full) {
          overflow[w] = 1;
          while (j < end && t_sorted[j] == tp) j++;
          i = j;
          continue;
        }
        i = j;
        if (col < 0) { agg_err.store(1); return; }  // violated precondition
        if (col >= W) { overflow[w] = 1; continue; }
        std::stable_sort(segs.begin(), segs.end(),
                         [](const Seg& a, const Seg& b) { return a.b3d < b.b3d; });
        int64_t base = (w * W + col) * K;
        int64_t ns = 0, cov = 0;
        for (size_t s = 0; s < segs.size(); s++) {
          if (segs[s].b3d == 0) cov += segs[s].count;
          if ((int64_t)s < K) {
            key_tab[base + (int64_t)s] = (int32_t)segs[s].key;
            cnt_tab[base + (int64_t)s] = (int32_t)segs[s].count;
            ns++;
          } else {
            overflow[w] = 1;
          }
        }
        coverage[w * W + col] = (int32_t)cov;
        n_slots[w * W + col] = (int32_t)ns;
      }
    }
  };
  if (T == 1) {
    work(0);
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < T; t++) threads.emplace_back(work, t);
    for (auto& th : threads) th.join();
  }
  if (agg_err.load()) return -5;
  return 0;
}

// CSR-direct pileup aggregation: same per-column dedup + b3-delta stable
// sort as np2_aggregate3, but emits the flat CSR entry stream the device
// dispatch uploads (pipeline/windows.split_csr format) WITHOUT materializing
// the dense [B, W, K] host tables: per-column slot counts ns (u8 [B*W]) and
// one (window, column, slot)-ordered stream of key_lo u16 / delta u8 /
// count u8. Entries whose delta or count exceeds a byte are appended to a
// shared exception list as (window, col, slot, full key, full count); the
// Python wrapper converts those to flat stream indices via the ns cumsum.
//
// Threads own contiguous window ranges and write their stream entries
// densely into private regions of the shared output buffers (region t
// starts at the prefix sum of the per-window bounds min(hi-lo, W*K));
// toffs/tcounts report each region's start and real length so the wrapper
// can compact with T<=16 slice copies. Returns the thread count, or
// -2 (nw > B) / -3 (exception list overflow; caller falls back).
int np2_aggregate_csr(const int32_t* t_sorted, const int32_t* k_sorted,
                      const int64_t* lo, const int64_t* hi,
                      const int64_t* lead,
                      int64_t nw, int64_t B, int64_t W, int64_t K,
                      int64_t n_threads,
                      uint8_t* ns_u8, uint16_t* keylo, uint8_t* dlo,
                      uint8_t* clo,
                      int64_t* toffs, int64_t* tcounts,
                      int32_t* xw, int32_t* xcol, int32_t* xslot,
                      int32_t* xkey, int32_t* xcnt, int64_t xcap,
                      int64_t* xcount, uint8_t* overflow) {
  std::fill(ns_u8, ns_u8 + B * W, 0);
  std::fill(overflow, overflow + B, 0);
  if (nw > B) return -2;
  if (K > 255) return -4;

  int T = (int)(n_threads < 1 ? 1 : (n_threads > 16 ? 16 : n_threads));
  int64_t total = 0;
  for (int64_t w = 0; w < nw; w++) total += hi[w] - lo[w];
  if (total < (int64_t)1 << 16) T = 1;
  std::vector<int64_t> wb(T + 1, nw);
  wb[0] = 0;
  {
    int64_t acc = 0, t = 1;
    for (int64_t w = 0; w < nw && t < T; w++) {
      acc += hi[w] - lo[w];
      while (t < T && acc >= total / T * t) { wb[t] = w + 1; t++; }
    }
  }
  for (int t = 1; t < T; t++) if (wb[t] < wb[t - 1]) wb[t] = wb[t - 1];
  // region offsets from per-window bounds (entries per window <= stream
  // length and <= W*K stored slots)
  {
    int64_t off = 0;
    for (int t = 0; t < T; t++) {
      toffs[t] = off;
      for (int64_t w = wb[t]; w < wb[t + 1]; w++) {
        int64_t m = hi[w] - lo[w], cap = W * K;
        off += m < cap ? m : cap;
      }
    }
  }
  std::atomic<int64_t> xn(0);
  std::atomic<int> agg_err(0);

  auto work = [&](int t) {
    struct Seg { int64_t key, count, b3d; };
    std::vector<Seg> segs;
    segs.reserve(256);
    const int HB = 13, HN = 1 << HB;
    const int64_t CAP = HN / 2;
    std::vector<int32_t> hkey(HN);
    std::vector<int32_t> hseg(HN);
    std::vector<uint32_t> hgen(HN, 0);
    uint32_t gen = 0;
    int64_t p = toffs[t];
    for (int64_t w = wb[t]; w < wb[t + 1]; w++) {
      int64_t i = lo[w], end = hi[w];
      int64_t ld = lead[w];
      while (i < end) {
        int32_t tp = t_sorted[i];
        int64_t col = (int64_t)tp - ld;
        segs.clear();
        gen++;
        bool full = false;
        int64_t j = i;
        for (; j < end && t_sorted[j] == tp; j++) {
          int32_t k = k_sorted[j];
          uint32_t h = ((uint32_t)k * 2654435761u) >> (32 - HB);
          for (;;) {
            if (hgen[h] != gen) {
              if ((int64_t)segs.size() >= CAP) { full = true; break; }
              hgen[h] = gen;
              hkey[h] = k;
              hseg[h] = (int32_t)segs.size();
              segs.push_back({(int64_t)(uint32_t)k, 1,
                              b3d_of_key((int64_t)(uint32_t)k)});
              break;
            }
            if (hkey[h] == k) { segs[hseg[h]].count++; break; }
            h = (h + 1) & (HN - 1);
          }
          if (full) break;
        }
        if (full) {
          overflow[w] = 1;
          while (j < end && t_sorted[j] == tp) j++;
          i = j;
          continue;
        }
        i = j;
        if (col < 0) {  // violated precondition: flag and abandon cleanly so
          agg_err.store(1);  // the wrapper falls back instead of consuming a
          tcounts[t] = p - toffs[t];  // misaligned stream (tcounts stays valid)
          return;
        }
        if (col >= W) { overflow[w] = 1; continue; }
        std::stable_sort(segs.begin(), segs.end(),
                         [](const Seg& a, const Seg& b) { return a.b3d < b.b3d; });
        int64_t ns = segs.size() < (size_t)K ? (int64_t)segs.size() : K;
        if ((int64_t)segs.size() > K) overflow[w] = 1;
        for (int64_t s = 0; s < ns; s++) {
          uint32_t key = (uint32_t)segs[s].key;
          int64_t cnt = segs[s].count;
          uint32_t delta = key >> 16;
          keylo[p] = (uint16_t)(key & 0xFFFF);
          dlo[p] = (uint8_t)(delta > 0xFF ? 0xFF : delta);
          clo[p] = (uint8_t)(cnt > 0xFF ? 0xFF : cnt);
          if (delta > 0xFF || cnt > 0xFF) {
            int64_t xi = xn.fetch_add(1);
            if (xi < xcap) {
              xw[xi] = (int32_t)w;
              xcol[xi] = (int32_t)col;
              xslot[xi] = (int32_t)s;
              xkey[xi] = (int32_t)key;
              xcnt[xi] = (int32_t)(cnt > 0x7FFFFFFF ? 0x7FFFFFFF : cnt);
            }
          }
          p++;
        }
        ns_u8[w * W + col] = (uint8_t)ns;
      }
    }
    tcounts[t] = p - toffs[t];
  };
  if (T == 1) {
    work(0);
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < T; t++) threads.emplace_back(work, t);
    for (auto& th : threads) th.join();
  }
  *xcount = xn.load();
  if (agg_err.load()) return -5;
  if (*xcount > xcap) return -3;
  return T;
}

// Per-absolute-column distinct-key counts over the whole t-sorted contig
// stream. A column's (t, key) distinct set is window-independent (keys pack
// per-column deltas, not window offsets), so one pass yields every window's
// max-slot bound for per-chunk K tiering (pipeline/engine.py): the DP kernel's
// unrolled slot loop costs O(K^2) per column, and most real HiFi columns carry
// <= 8 distinct 3-mers while pathological pileups need the full K. Counts are
// clamped to 0x7FFF (tier decisions only compare against small K tiers).
int np2_col_slots(const int32_t* t_sorted, const int32_t* k_sorted,
                  int64_t n, int64_t n_pos, int64_t n_threads,
                  int32_t* out_counts) {
  std::fill(out_counts, out_counts + n_pos, 0);
  int T = (int)(n_threads < 1 ? 1 : (n_threads > 16 ? 16 : n_threads));
  if (n < (int64_t)1 << 16) T = 1;
  // split the stream at column boundaries
  std::vector<int64_t> sb(T + 1, n);
  sb[0] = 0;
  for (int t = 1; t < T; t++) {
    int64_t i = n / T * t;
    while (i < n && i > 0 && t_sorted[i] == t_sorted[i - 1]) i++;
    sb[t] = i;
  }
  for (int t = 1; t < T; t++) if (sb[t] < sb[t - 1]) sb[t] = sb[t - 1];
  auto work = [&](int t) {
    const int HB = 13, HN = 1 << HB;
    const int64_t CAP = 0x7FFF;
    std::vector<int32_t> hkey(HN);
    std::vector<uint32_t> hgen(HN, 0);
    uint32_t gen = 0;
    int64_t i = sb[t], end = sb[t + 1];
    while (i < end) {
      int32_t tp = t_sorted[i];
      gen++;
      int64_t cnt = 0;
      int64_t j = i;
      for (; j < end && t_sorted[j] == tp; j++) {
        int32_t k = k_sorted[j];
        uint32_t h = ((uint32_t)k * 2654435761u) >> (32 - HB);
        for (;;) {
          if (hgen[h] != gen) {
            hgen[h] = gen;
            hkey[h] = k;
            cnt++;
            break;
          }
          if (hkey[h] == k) break;
          h = (h + 1) & (HN - 1);
          if (cnt >= (HN >> 1)) break;  // load cap: count saturates
        }
        if (cnt >= (HN >> 1)) {
          // saturated column: skip its remaining entries
          while (j < end && t_sorted[j] == tp) j++;
          cnt = CAP;
          break;
        }
      }
      if (tp >= 0 && tp < n_pos)
        out_counts[tp] = (int32_t)(cnt > CAP ? CAP : cnt);
      i = j;
    }
  };
  if (T == 1) {
    work(0);
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < T; t++) threads.emplace_back(work, t);
    for (auto& th : threads) th.join();
  }
  return 0;
}

// Host-fallback windowed Viterbi DP for windows exceeding the device's
// static slot bound (structural-variant pileup columns with hundreds to
// thousands of distinct 3-mers). Exact twin of pipeline/host_fallback.py
// (itself the no-caps mirror of the device DP, reference main.rs:1645-1687):
// variable-length slot lists, no delta-level cap, anchor seeding, identical
// tie rules (strict >, or == with non-gap predecessor first base, last such j
// winning). Predecessor matching is hash-bucketed per column — the match key
// (b2 tuple + b3d/q3) packs exactly into 62 bits, so bucketing cannot change
// results — which removes the O(slots^2) scan the Python fallback pays on
// 32k-slot columns. cols must be nondecreasing (the t-sorted window stream).
// Emits the reversed walk into caller buffers of capacity out_cap; returns 0,
// or -1 on invalid input / -2 if out_cap is too small / -3 width too wide.
int np2_host_window_dp(const int32_t* cols, const int32_t* keys, int64_t n,
                       int64_t width, int64_t lead_abs, int64_t last_col,
                       int32_t seed_anchor,
                       int32_t* out_col, int32_t* out_q3,
                       int32_t* out_cnt, int32_t* out_cov,
                       int64_t* out_n, int64_t* out_best, int64_t out_cap) {
  if (n <= 0 || width <= 0) return -1;
  if (width >= ((int64_t)1 << 20)) return -3;  // b2_t must fit 20 bits
  const int64_t NEG = -((int64_t)1 << 40);
  const int HEAD_Q = 15;

  struct Slot {
    int32_t key;
    int64_t count;
    int32_t b3d;    // clamped to i32 (delta < 2^16)
  };
  // per-column slot lists in reference order (b3d, then first occurrence)
  std::vector<std::vector<Slot>> col_slots((size_t)width);
  std::vector<int64_t> coverage((size_t)width, 0);
  {
    // dedup per column segment (stream is col-sorted; within a column the
    // order is first-occurrence), then stable-sort by b3d
    std::unordered_map<int32_t, size_t> seen;
    int64_t i = 0;
    while (i < n) {
      int32_t c = cols[i];
      if (c < 0 || c >= width) return -1;
      seen.clear();
      auto& slots = col_slots[(size_t)c];
      int64_t j = i;
      for (; j < n && cols[j] == c; j++) {
        int32_t k = keys[j];
        auto it = seen.find(k);
        if (it == seen.end()) {
          seen.emplace(k, slots.size());
          slots.push_back({k, 1, (int32_t)b3d_of_key((int64_t)(uint32_t)k)});
        } else {
          slots[it->second].count++;
        }
      }
      std::stable_sort(slots.begin(), slots.end(),
                       [](const Slot& a, const Slot& b) { return a.b3d < b.b3d; });
      int64_t cov = 0;
      for (auto& s : slots) if (s.b3d == 0) cov += s.count;
      coverage[(size_t)c] = cov;
      i = j;
    }
  }

  // decoded per-slot fields + DP state, column-local
  auto decode = [](int32_t key, int64_t col, int64_t& b1t, int64_t& b1d,
                   int64_t& b1q, int64_t& b2t, int64_t& b2d, int64_t& b2q,
                   int64_t& q3) {
    int64_t k = (int64_t)(uint32_t)key;
    int64_t flags = (k >> 12) & 0xF;
    int64_t delta = (k >> 16) & 0xFFFF;
    b1q = (k >> 8) & 0xF;
    b2q = (k >> 4) & 0xF;
    q3 = k & 0xF;
    if ((flags & 0b0101) == 0b0101) {
      b1t = col; b1d = delta; b2t = col; b2d = delta + 1;
    } else if (flags & 0b0001) {
      b1t = col - 1; b1d = delta; b2t = col; b2d = 0;
    } else if (flags & 0b0100) {
      b1t = col - 1; b1d = delta; b2t = col - 1; b2d = delta + 1;
    } else {
      b1t = col - 2; b1d = delta; b2t = col - 1; b2d = 0;
    }
  };
  // 62-bit exact pack of (b2 tuple, b3d, q3): t 20 | d 17 | q 4 | b3d 17 | q3 4
  auto combo = [](int64_t t, int64_t d, int64_t q, int64_t b3d, int64_t q3) {
    return ((uint64_t)t << 42) | ((uint64_t)d << 25) | ((uint64_t)q << 21) |
           ((uint64_t)b3d << 4) | (uint64_t)q3;
  };

  std::vector<std::vector<int64_t>> score((size_t)width);
  std::vector<std::vector<int32_t>> besti((size_t)width);
  // per-column bucket: combo(j.b2, j.b3d, j.q3) -> ascending slot indices
  std::vector<std::unordered_map<uint64_t, std::vector<int32_t>>> bucket(
      (size_t)width);
  for (int64_t c = 0; c < width; c++) {
    auto& slots = col_slots[(size_t)c];
    if (slots.empty()) continue;
    score[(size_t)c].assign(slots.size(), NEG);
    besti[(size_t)c].assign(slots.size(), 0);
    auto& bk = bucket[(size_t)c];
    bk.reserve(slots.size() * 2);
    for (size_t si = 0; si < slots.size(); si++) {
      int64_t b1t, b1d, b1q, b2t, b2d, b2q, q3;
      decode(slots[si].key, c, b1t, b1d, b1q, b2t, b2d, b2q, q3);
      bk[combo(b2t, b2d, b2q, slots[si].b3d, q3)].push_back((int32_t)si);
    }
    int64_t cov = coverage[(size_t)c];
    for (size_t si = 0; si < slots.size(); si++) {
      int64_t b1t, b1d, b1q, b2t, b2d, b2q, q3;
      decode(slots[si].key, c, b1t, b1d, b1q, b2t, b2d, b2q, q3);
      int64_t gain = 10 * slots[si].count - 4 * cov;
      if (b2q == HEAD_Q) {
        score[(size_t)c][si] = gain;
        continue;
      }
      int64_t pt = b2t;
      if (pt < 0 || pt >= width) continue;  // stays NEG
      // match: j.b2 == my b1 and (pt, j.b3d, j.q3) == my b2 — my b2's t is
      // pt by pool choice, so the bucket key is (b1 tuple, b2d, b2q)
      auto& pbk = bucket[(size_t)pt];
      auto it = pbk.find(combo(b1t, b1d, b1q, b2d, b2q));
      if (it == pbk.end()) continue;
      auto& pslots = col_slots[(size_t)pt];
      auto& pscore = score[(size_t)pt];
      bool head_guard = (pt + lead_abs) >= 3;
      int64_t best = NEG;
      int32_t bj = 0;
      for (int32_t j : it->second) {
        int64_t jb1t, jb1d, jb1q, jb2t, jb2d, jb2q, jq3;
        decode(pslots[(size_t)j].key, pt, jb1t, jb1d, jb1q, jb2t, jb2d,
               jb2q, jq3);
        if (head_guard && jb1q == HEAD_Q) continue;
        int64_t cand = pscore[(size_t)j] + gain;
        // reference tie rule verbatim (host_fallback.py:105): strict >, or
        // == with the predecessor's first base a non-gap (last such j wins)
        if (cand > best || (cand == best && jb1q != 4)) {
          best = cand;
          bj = j;
        }
      }
      score[(size_t)c][si] = best;
      besti[(size_t)c][si] = bj;
    }
    if (seed_anchor && c == 2)
      for (size_t si = 0; si < slots.size(); si++) score[(size_t)c][si] = 0;
  }

  // backtrack: last-max slot at last_col (>= scan keeps the LAST max)
  if (last_col < 0 || last_col >= width || col_slots[(size_t)last_col].empty())
    return -1;
  {
    auto& fs = score[(size_t)last_col];
    int64_t mx = NEG;
    size_t si = 0;
    for (size_t k = 0; k < fs.size(); k++)
      if (fs[k] >= mx) { mx = fs[k]; si = k; }
    *out_best = mx;
    int64_t c = last_col;
    int32_t i = (int32_t)si;
    int64_t m = 0;
    for (;;) {
      const Slot& s = col_slots[(size_t)c][(size_t)i];
      int64_t b1t, b1d, b1q, b2t, b2d, b2q, q3;
      decode(s.key, c, b1t, b1d, b1q, b2t, b2d, b2q, q3);
      if (q3 != 4) {
        if (m >= out_cap) return -2;
        out_col[m] = (int32_t)c;
        out_q3[m] = (int32_t)q3;
        out_cnt[m] = (int32_t)(s.count > 0x7FFFFFFF ? 0x7FFFFFFF : s.count);
        out_cov[m] = (int32_t)(coverage[(size_t)c] > 0x7FFFFFFF
                                   ? 0x7FFFFFFF : coverage[(size_t)c]);
        m++;
      }
      if (b2q == HEAD_Q || (seed_anchor && c == 2)) break;
      int64_t nc = b2t;
      if (nc < 0) break;
      int32_t ni = besti[(size_t)c][(size_t)i];
      if (nc >= width || (size_t)ni >= col_slots[(size_t)nc].size())
        return -1;  // inconsistent stream (the Python spec would throw too)
      i = ni;
      c = nc;
    }
    *out_n = m;
  }
  return 0;
}

// ---------- memory prefault ----------

// Grow the process heap by `bytes` and fault it in with `threads` threads and
// 2 MB THP pages, then free (the package-level mallopt keeps it mapped for
// reuse). Pays the hypervisor's slow page provisioning once, up front, at the
// best achievable rate instead of lazily at ~4 MB/s inside the pipeline.
// Greedy anchor-bounded window planning (pipeline/windows.plan_windows
// semantics, exactly): each window ends at the last anchor within `target`
// columns of its start (or stretches to the next anchor / contig end).
// mode 0 counts windows into *out_n; mode 1 fills out_starts/out_ends
// (i64[*out_n]). O(n_pos + nw log A) — replaces a Python while-loop that is
// O(nw) interpreter work on multi-Mb contigs (human T2T ~ 3M windows).
int np2_plan_windows(const uint8_t* anchors, int64_t n_pos, int64_t target,
                     int mode, int64_t* out_n,
                     int64_t* out_starts, int64_t* out_ends) {
  std::vector<int64_t> aidx;
  aidx.reserve(1 << 12);
  for (int64_t i = 0; i < n_pos; i++) if (anchors[i]) aidx.push_back(i);
  const int64_t A = (int64_t)aidx.size();
  int64_t n = 0;
  int64_t s = 0;
  if (mode == 1) out_starts[0] = 0;
  for (;;) {
    if (s + target >= n_pos) {
      if (mode == 1) out_ends[n] = n_pos - 1;
      n++;
      break;
    }
    int64_t e;
    int64_t j = std::upper_bound(aidx.begin(), aidx.end(), s + target)
                - aidx.begin() - 1;
    if (j >= 0 && aidx[j] > s) {
      e = aidx[j];
    } else {
      int64_t j2 = std::lower_bound(aidx.begin(), aidx.end(), s + 1)
                   - aidx.begin();
      e = j2 < A ? aidx[j2] : n_pos - 1;
    }
    if (mode == 1) out_ends[n] = e;
    n++;
    if (e >= n_pos - 1) break;
    s = e;
    if (mode == 1) out_starts[n] = e;
  }
  *out_n = n;
  return 0;
}

// Per-window max column slot count over [lead, end] inclusive
// (pipeline/windows.window_max_slots). Adjacent windows overlap by ~3
// columns, so the total scan is O(n_pos); threads split the window list.
int np2_window_max(const int32_t* colslots, int64_t n_pos,
                   const int64_t* lead, const int64_t* ends, int64_t nw,
                   int64_t n_threads, int32_t* out) {
  int T = (int)(n_threads < 1 ? 1 : (n_threads > 16 ? 16 : n_threads));
  if (nw < 256) T = 1;
  auto work = [&](int t) {
    int64_t w0 = nw / T * t, w1 = (t == T - 1) ? nw : nw / T * (t + 1);
    for (int64_t w = w0; w < w1; w++) {
      int32_t m = 0;
      int64_t e = ends[w] < n_pos - 1 ? ends[w] : n_pos - 1;
      for (int64_t i = lead[w]; i <= e; i++)
        if (colslots[i] > m) m = colslots[i];
      out[w] = m;
    }
  };
  if (T == 1) {
    work(0);
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < T; t++) threads.emplace_back(work, t);
    for (auto& th : threads) th.join();
  }
  return 0;
}

// First index in [lo, hi) whose tag position is >= x, or hi: a gallop
// forward from lo, then a binary search within the last step. Positions
// are non-decreasing, and all of them before lo are < x.
static inline int64_t tag_lower_bound(const int32_t* tp, int64_t lo,
                                      int64_t hi, int32_t x) {
  int64_t prev = lo, step = 1;
  while (lo < hi && tp[lo] < x) {
    prev = lo + 1;
    lo += step;
    step <<= 1;
  }
  if (lo > hi) lo = hi;
  return std::lower_bound(tp + prev, tp + lo, x) - tp;
}

// Per-read LQ candidate-allele extraction, pass 1 (the reference's hot loop 3,
// main.rs:1429-1523; Python spec models/oracle_lq.py:_extract_alleles_py).
// Walks the alignments IN ORDER with the reference's sticky region cursor;
// within a read, walks its regions in ascending genome order over its tags
// once: each region's first tag is a forward search from the previous
// region's, the allele is its valid (non-gap) tags up to the region's end,
// and the first ksize valid tags from there roll into the canonical
// pre-hash min(fwd, rev) with the release-Rust wrapped-shift semantics for
// k >= 32 (shift amounts mod 64). Both stay within the reference's decode
// limit: one tag past the last tag at or before rend[j] + ksize.
//
// mode 0: count pass -> *out_m (entries) and *out_bytes (total allele chars).
// mode 1: fill pass  -> out_region i32[M] (region index, descending-order
// array), out_order i32[M] (alignment index), out_soff i64[M+1] exclusive
// byte offsets (out_soff[0] = 0), out_seq u8 ASCII, out_prehash u64[M],
// out_has u8[M] (0 -> no k-mer, prehash undefined). A region's entries come
// in alignment order; within one alignment, regions in ascending genome order.
// Both modes: *out_pairs, the (alignment, region) pairs visited.
// Inputs: concatenated per-alignment (t_pos i32, q_base u8) with offsets
// aoff i64[A+1]; per-alignment aln_t_s/aln_t_e + active flags; regions
// rstart/rend i64[R] in DESCENDING genome order with initial seq counts
// nseq0 i32[R]; ksize; max_can (LQSEQ_MAX_CAN_COUNT = 60, main.rs:30).
int np2_extract_alleles(const int32_t* t_pos, const uint8_t* q_base,
                        const int64_t* aoff, int64_t A,
                        const int64_t* aln_t_s, const int64_t* aln_t_e,
                        const uint8_t* active,
                        const int64_t* rstart, const int64_t* rend,
                        const int32_t* nseq0, int64_t R,
                        int64_t ksize, int64_t max_can, int mode,
                        int64_t* out_m, int64_t* out_bytes,
                        int64_t* out_pairs,
                        int32_t* out_region, int32_t* out_order,
                        int64_t* out_soff, uint8_t* out_seq,
                        uint64_t* out_prehash, uint8_t* out_has) {
  *out_pairs = 0;
  if (R == 0 || A == 0) { *out_m = 0; *out_bytes = 0; return 0; }
  static const char C2A[8] = {'A', 'C', 'G', 'T', '-', 'N', 'M', '-'};
  const int shift = (int)((2 * (ksize - 1)) & 63);
  const int msh = (int)((2 * ksize) & 63);
  const uint64_t mask = msh ? ((1ULL << msh) - 1) : 0;  // k=32 -> 0 (RFC 560)
  std::vector<int32_t> queued(R, 0);
  int64_t s = R - 1;
  int64_t m = 0, bytes_acc = 0, pairs = 0;
  if (mode == 1) out_soff[0] = 0;
  for (int64_t a = 0; a < A; a++) {
    if (!active[a]) continue;
    const int64_t n = aoff[a + 1] - aoff[a];
    if (n == 0) continue;
    while (s > 0 && rstart[s] < aln_t_s[a]) s--;
    if (rstart[s] < aln_t_s[a] || rend[s] > aln_t_e[a]) continue;
    int64_t j = s;
    while (j > 0 && rend[j] <= aln_t_e[a]) j--;
    if (rend[j] > aln_t_e[a]) j++;
    pairs += s - j + 1;
    const int32_t* tp = t_pos + aoff[a];
    const uint8_t* qb = q_base + aoff[a];
    // decode tags until t_pos > rend[j] + ksize, + one extra (spec: stop+1)
    const int32_t tlim = (int32_t)(rend[j] + ksize);
    const int64_t stop = std::upper_bound(tp, tp + n, tlim) - tp;
    const int64_t limit = stop < n ? stop + 1 : n;
    int64_t lo = 0;
    int32_t prev_start = INT32_MIN;
    for (int64_t r = s; r >= j; r--) {
      if ((int64_t)nseq0[r] + queued[r] >= max_can) continue;
      const int32_t rs = (int32_t)rstart[r], re = (int32_t)rend[r];
      if (rs < prev_start) lo = 0;  // regions out of order: search afresh
      prev_start = rs;
      lo = tag_lower_bound(tp, lo, limit, rs);
      int64_t i1 = lo, nb = 0;
      uint8_t* dst = mode == 1 ? out_seq + out_soff[m] : nullptr;
      for (; i1 < limit && tp[i1] <= re; i1++) {
        if (qb[i1] == 4) continue;
        if (dst) dst[nb] = (uint8_t)C2A[qb[i1] & 7];
        nb++;
      }
      if (nb == 0) continue;  // empty allele -> the reference appends nothing
      queued[r]++;
      if (mode == 0) { m++; bytes_acc += nb; continue; }
      out_region[m] = (int32_t)r;
      out_order[m] = (int32_t)a;
      out_soff[m + 1] = out_soff[m] + nb;
      uint64_t kf = 0, kr = 0;
      int64_t got = 0;
      for (int64_t i = lo; i < limit && got < ksize; i++) {
        const uint64_t b = qb[i];
        if (b == 4) continue;
        kf = ((kf << 2) | b) & mask;
        kr = (kr >> 2) | ((3ULL ^ b) << shift);
        got++;
      }
      out_has[m] = got == ksize;
      out_prehash[m] = got == ksize ? (kf < kr ? kf : kr) : 0;
      m++;
    }
  }
  *out_m = m;
  *out_bytes = bytes_acc;
  *out_pairs = pairs;
  return 0;
}

int np2_prefault(int64_t bytes, int64_t n_threads) {
  if (bytes <= 0) return 0;
  char* p = (char*)malloc((size_t)bytes);
  if (!p) return -1;
  madvise(p, (size_t)bytes, MADV_HUGEPAGE);
  // Touch ONLY pages that are not already resident (mincore): the package
  // mallopt keeps freed heap pages provisioned, so the per-contig
  // re-prefault of an already-warm heap must cost ~a mincore scan (ms),
  // not one cache-missing write per 4 KB of GBs (~4 s/contig measured on
  // the round-4 E. coli profile — it was the largest single-contig stage).
  const size_t PG = 4096;
  size_t base = (size_t)p & ~(PG - 1);
  size_t len = (size_t)p + (size_t)bytes - base;
  size_t npages = (len + PG - 1) / PG;
  unsigned char* vec = (unsigned char*)malloc(npages);
  bool have_vec = vec && mincore((void*)base, len, vec) == 0;
  int T = (int)(n_threads < 1 ? 1 : (n_threads > 16 ? 16 : n_threads));
  auto work = [&](int t) {
    size_t lo = npages / T * t, hi = (t == T - 1) ? npages : npages / T * (t + 1);
    for (size_t i = lo; i < hi; i++) {
      if (have_vec && (vec[i] & 1)) continue;  // already resident
      volatile char* q = (volatile char*)(base + i * PG);
      if ((char*)q < p) q = (volatile char*)p;  // head partial page
      *q = 0;
    }
  };
  if (T == 1) {
    work(0);
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < T; t++) threads.emplace_back(work, t);
    for (auto& th : threads) th.join();
  }
  free(vec);
  free(p);
  return 0;
}

}  // extern "C"

// ---------- sequential range scanner (chromosome-scale segmented ingest) ----
//
// One forward pass over a contig's records serving ascending position-range
// requests with bounded memory: each kept record is decoded + filtered +
// trimmed + expanded ONCE (analyze_record/emit_tags, identical semantics to
// np2_extract_begin3/fetch3) and held in a carry until no later range can
// need it. The clip filter (filter_alignseqs_by_clip, main.rs:531-574) runs
// incrementally: the covered-range chain is built in record order as the scan
// advances, and a clipped record's verdict is only read once the scan
// frontier is provably past any read that could still extend a range over it
// (an unscanned record extends the open range only if its margin-adjusted
// start <= open_e, and starts are >= frontier — so once frontier >= end +
// 2*margin + slack the verdict is final).

namespace {

struct CarryRec {
  int64_t order;             // global kept-record ordinal (1-based; ref = 0)
  int64_t aln_t_s, aln_t_e;  // post-trim bounds (absolute)
  uint8_t clip;              // raw clip label (pre filter)
  uint8_t drop;              // clip-filter verdict (valid once decided)
  uint8_t decided;
  std::vector<int32_t> t, k; // expanded tag stream (absolute t)
};

struct RangeScan {
  BamFile* bf = nullptr;
  Filters f{};
  std::vector<uint8_t> tseq_copy;  // owned copy (caller array may be freed)
  int64_t clip_margin = 50;
  int32_t want_tid = -1;
  // BGZF streaming state (bgzf path)
  BgzfScan* sc = nullptr;
  std::vector<uint8_t> ubuf;
  size_t cursor = 0;
  int64_t skip_first = 0;          // uncompressed offset into first block
  // plain-gzip path: cursor walks bf->raw directly
  size_t raw_cursor = 0;
  bool raw_positioned = false;
  bool done = false;               // contig exhausted
  int64_t prev_pos = -1;
  int64_t frontier = -1;           // pos of last scanned record
  std::deque<CarryRec> carry;
  int64_t order_ctr = 0;
  // incremental clip chain (mirrors filter_by_clip construction)
  std::vector<int64_t> closed_s, closed_e;
  int64_t open_s = 0, open_e = 0;
  // pending emitted set (between next and fetch)
  std::vector<CarryRec*> set;
  int64_t set_stream = 0, base = 0, maxt = 0;
  std::vector<uint8_t> sq, st;     // analyze scratch
  // staged raw record copies (4-byte size prefix + payload) awaiting the
  // PARALLEL analyze/expand pass (rs_flush); staged in scan order
  std::vector<std::vector<uint8_t>> batch;
  // free pool of expanded-tag buffers: evicted carry records donate their
  // t/k vectors, new records reuse them. Without this every record
  // malloc'd ~100 KB of FRESH heap (the allocator fragments the churn), so
  // a chromosome-scale pass paid the hypervisor page-provisioning rate for
  // every segment's ~4 GB of carry — measured 7 s vs 43 s wall for
  // identical 500M-entry segments depending on page warmth.
  std::vector<std::vector<int32_t>> vpool;
  std::mutex vpool_mu;
  int n_threads = 4;
  ~RangeScan() {
    delete sc;
    if (bf) delete bf;
  }
};

// Ensure at least `need` unconsumed bytes in rs.ubuf (bgzf path). Returns
// false at clean end-of-stream with fewer than `need` bytes, or on error
// (sets rs.done either way; *err set negative on corrupt input).
static bool rs_ensure(RangeScan& rs, size_t need, int* err) {
  std::vector<uint8_t> blk;
  while (rs.ubuf.size() - rs.cursor < need) {
    if (rs.cursor > (size_t)(1 << 23)) {
      rs.ubuf.erase(rs.ubuf.begin(), rs.ubuf.begin() + rs.cursor);
      rs.cursor = 0;
    }
    int64_t bcoff = 0;
    int us = rs.sc->next(blk, &bcoff);
    if (us == -1) return false;
    if (us < -1) { *err = -3; return false; }
    size_t from = 0;
    if (rs.skip_first > 0) {
      from = (size_t)std::min<int64_t>(rs.skip_first, us);
      rs.skip_first -= (int64_t)from;
    }
    rs.ubuf.insert(rs.ubuf.end(), blk.begin() + from, blk.begin() + us);
  }
  return true;
}

// Peek the next record's (tid, pos) without consuming. Returns 1 on success,
// 0 at end of contig/stream (rs.done set), negative on corrupt input.
static int rs_peek(RangeScan& rs, int32_t* pos_out, const uint8_t** q_out,
                   uint32_t* bs_out) {
  if (rs.done) return 0;
  int err = 0;
  if (rs.bf->bgzf) {
    if (!rs_ensure(rs, 4, &err)) { rs.done = true; return err ? err : 0; }
    uint32_t bs = rd_u32(rs.ubuf.data() + rs.cursor);
    if (bs < 32 || bs > (1u << 30)) return -3;
    if (!rs_ensure(rs, 4 + (size_t)bs, &err)) { rs.done = true; return err ? err : 0; }
    const uint8_t* q = rs.ubuf.data() + rs.cursor + 4;
    int32_t tid = rd_i32(q);
    if (tid != rs.want_tid) { rs.done = true; return 0; }
    *pos_out = rd_i32(q + 4);
    *q_out = q;
    *bs_out = bs;
    return 1;
  }
  // plain-gzip: walk the resident stream; position to the contig lazily
  const uint8_t* p = rs.bf->raw.d.data();
  size_t n = rs.bf->raw.d.size();
  if (!rs.raw_positioned) {
    rs.raw_cursor = rs.bf->rec_off;
    rs.raw_positioned = true;
  }
  for (;;) {
    if (rs.raw_cursor + 4 > n) { rs.done = true; return 0; }
    uint32_t bs = rd_u32(p + rs.raw_cursor);
    if (bs < 32 || rs.raw_cursor + 4 + bs > n) return -3;
    const uint8_t* q = p + rs.raw_cursor + 4;
    int32_t tid = rd_i32(q);
    if (tid > rs.want_tid || tid < 0) { rs.done = true; return 0; }
    if (tid < rs.want_tid) { rs.raw_cursor += 4 + bs; continue; }
    *pos_out = rd_i32(q + 4);
    *q_out = q;
    *bs_out = bs;
    return 1;
  }
}

// Stage the peeked record (q/bs from rs_peek): cheap ordered copy; the
// filter/expand/trim runs in the PARALLEL rs_flush pass. Returns 0 or
// negative error.
static int rs_stage(RangeScan& rs, const uint8_t* q, uint32_t bs) {
  int32_t pos = rd_i32(q + 4);
  if ((int64_t)pos < rs.prev_pos) return -4;  // unsorted (main.rs:1753)
  rs.prev_pos = pos;
  rs.frontier = pos;
  rs.batch.emplace_back(q - 4, q + bs);  // keep the size prefix: parse_rec
  //                                        reads q[-4] on the long-CIGAR path
  if (rs.bf->bgzf) rs.cursor += 4 + bs;
  else rs.raw_cursor += 4 + bs;
  return 0;
}

static void rs_pool_put(RangeScan& rs, CarryRec& cr) {
  std::lock_guard<std::mutex> g(rs.vpool_mu);
  if (rs.vpool.size() < (1u << 20)) {
    if (cr.t.capacity()) rs.vpool.emplace_back(std::move(cr.t));
    if (cr.k.capacity()) rs.vpool.emplace_back(std::move(cr.k));
  }
}

static void rs_pool_get(RangeScan& rs, std::vector<int32_t>& v) {
  std::lock_guard<std::mutex> g(rs.vpool_mu);
  if (!rs.vpool.empty()) {
    v = std::move(rs.vpool.back());
    rs.vpool.pop_back();
  }
}

// Analyze + expand the staged batch in parallel (per-record independent),
// then finalize IN ORDER: global order assignment, clip-chain construction
// (reference order matters, main.rs:537-556) and carry append.
static int rs_flush(RangeScan& rs) {
  size_t nb = rs.batch.size();
  if (!nb) return 0;
  int T = rs.n_threads < 1 ? 1 : (rs.n_threads > 16 ? 16 : rs.n_threads);
  if (nb < 64) T = 1;
  std::vector<uint8_t> kept(nb, 0);
  std::vector<CarryRec> recs(nb);
  std::vector<int> errs(T, 0);
  auto work = [&](int t) {
    std::vector<uint8_t> qs, ts;
    for (size_t i = nb * (size_t)t / T; i < nb * (size_t)(t + 1) / T; i++) {
      const uint8_t* q = rs.batch[i].data() + 4;
      BamRec r;
      parse_rec(q, r);
      int e = 0;
      const std::vector<uint8_t>* sub = sub_for(*rs.bf, q, r.flag, &e);
      if (e) { errs[t] = e; return; }
      RecInfo ri;
      if (!analyze_record(r, rs.f, qs, ts, ri, sub)) continue;
      kept[i] = 1;
      CarryRec& cr = recs[i];
      cr.aln_t_s = ri.aln_t_s;
      cr.aln_t_e = ri.aln_t_e;
      cr.clip = ri.clip ? 1 : 0;
      cr.drop = 0;
      cr.decided = 0;
      int64_t len = ri.new_len - ri.shift;
      rs_pool_get(rs, cr.t);  // reuse an evicted record's buffer when one
      rs_pool_get(rs, cr.k);  // is free: steady-state carry churn stays on
      //                         warm pages (no fresh provisioning)
      cr.t.resize((size_t)len);
      cr.k.resize((size_t)len);
      emit_tags(qs, ts, ri, cr.t.data(), cr.k.data());
    }
  };
  if (T == 1) {
    work(0);
  } else {
    std::vector<std::thread> ths;
    for (int t = 0; t < T; t++) ths.emplace_back(work, t);
    for (auto& th : ths) th.join();
  }
  for (int t = 0; t < T; t++) if (errs[t]) { rs.batch.clear(); return errs[t]; }
  for (size_t i = 0; i < nb; i++) {
    if (!kept[i]) continue;
    CarryRec& cr = recs[i];
    rs.order_ctr++;
    cr.order = rs.order_ctr;
    if (!cr.clip) {
      int64_t ats = cr.aln_t_s + rs.clip_margin;
      int64_t ate = cr.aln_t_e - rs.clip_margin;
      if (rs.open_s == rs.open_e) {
        rs.open_s = ats; rs.open_e = ate;
      } else if (ats > rs.open_e) {
        rs.closed_s.push_back(rs.open_s);
        rs.closed_e.push_back(rs.open_e);
        rs.open_s = ats; rs.open_e = ate;
      } else if (rs.open_e < ate) {
        rs.open_e = ate;
      }
    }
    rs.carry.emplace_back(std::move(cr));
  }
  rs.batch.clear();
  return 0;
}

static void rs_decide_clip(RangeScan& rs, CarryRec& cr) {
  if (cr.decided) return;
  cr.decided = 1;
  cr.drop = 0;
  if (!cr.clip) return;
  // in_ranges over closed ranges (insertion order, early break) then the
  // open range — identical to the global list where the open range is last
  for (size_t i = 0; i < rs.closed_s.size(); i++) {
    if (rs.closed_s[i] <= cr.aln_t_s && cr.aln_t_e <= rs.closed_e[i]) {
      cr.drop = 1;
      return;
    }
    if (cr.aln_t_e < rs.closed_s[i]) return;
  }
  if (rs.open_s != rs.open_e && rs.open_s <= cr.aln_t_s &&
      cr.aln_t_e <= rs.open_e)
    cr.drop = 1;
}

}  // namespace

extern "C" {

void* np2_range_open(const char* bam_path, int32_t tid,
                     const uint8_t* tseq_codes, int64_t tlen,
                     int64_t min_map_qual, int64_t min_read_len,
                     int64_t min_map_len, double min_map_fra,
                     int64_t max_clip_len, int64_t use_secondary,
                     int64_t use_supplementary, int64_t trim_len,
                     int64_t short_ref_len, int64_t clip_margin,
                     int64_t n_threads) {
  init_tables();
  BamFile* bf = static_cast<BamFile*>(np2_open(bam_path));
  if (!bf) return nullptr;
  RangeScan* rs = new RangeScan();
  rs->n_threads = (int)(n_threads < 1 ? 1 : n_threads);
  rs->bf = bf;
  rs->tseq_copy.assign(tseq_codes, tseq_codes + tlen);
  rs->f = Filters{rs->tseq_copy.data(), tlen, min_map_qual, min_read_len,
                  min_map_len, min_map_fra, max_clip_len, use_secondary,
                  use_supplementary, (int)trim_len, short_ref_len};
  bf->v3_f = rs->f;  // sub_for reads use_secondary from v3_f
  rs->clip_margin = clip_margin;
  rs->want_tid = tid;
  if (use_secondary) prefetch_secondary(*bf);
  if (bf->bgzf) {
    if (tid < 0 || tid >= (int32_t)bf->refs.size()) { delete rs; return nullptr; }
    uint64_t vbeg = bf->tid_vbeg[(size_t)tid];
    uint64_t vend = bf->tid_vend[(size_t)tid];
    if (vend <= vbeg) {
      rs->done = true;  // no records for this contig
    } else {
      rs->sc = new BgzfScan(bf->fd, bf->fsize);
      rs->sc->coff = (int64_t)(vbeg >> 16);
      rs->skip_first = (int64_t)(vbeg & 0xFFFF);
    }
  }
  return rs;
}

void np2_range_close(void* handle) {
  delete static_cast<RangeScan*>(handle);
}

// Advance the scan to serve [t_lo, t_hi): evicts carry records that no later
// range can need (aln_t_e < t_lo), scans records with pos < t_hi, then scans
// far enough past the set's max end that every member's clip verdict is
// final. Reports the set's sizes and coordinate base. Safe to call again
// with the same t_lo and a larger t_hi (segment extension).
//
// extract_mode: also include carry records whose trimmed start lands AT or
// past t_hi but whose global order precedes a member's — allele extraction
// (main.rs:1440-1523) walks reads with a monotone region cursor driven by a
// running max of aln_t_s, so a boundary record whose trim pushed its start
// past the segment can still gate a later (start-inverted) read's appends;
// the set must carry them for exact cursor parity (pipeline/segmented.py
// pass B). Newly scanned records get higher orders and can never join, so
// the verdict lookahead still converges.
int np2_range_next(void* handle, int64_t t_lo, int64_t t_hi,
                   int64_t extract_mode,
                   int64_t* stream_n, int64_t* reads_n,
                   int64_t* base_out, int64_t* maxt_out) {
  RangeScan& rs = *static_cast<RangeScan*>(handle);
  // evict: no future range (all have t_lo' >= t_lo) can touch these
  // (buffers go to the pool for reuse by newly scanned records)
  while (!rs.carry.empty() && rs.carry.front().aln_t_e < t_lo) {
    rs_pool_put(rs, rs.carry.front());
    rs.carry.pop_front();
  }
  if (rs.carry.size() > 1 && rs.carry.front().aln_t_e >= t_lo) {
    // interior evictions (deque not sorted by end): compact in place
    std::deque<CarryRec> kept;
    for (auto& cr : rs.carry) {
      if (cr.aln_t_e >= t_lo) kept.emplace_back(std::move(cr));
      else rs_pool_put(rs, cr);
    }
    rs.carry.swap(kept);
  }
  // prune chain ranges that can no longer contain any future member
  size_t np = 0;
  while (np < rs.closed_e.size() && rs.closed_e[np] < t_lo) np++;
  if (np) {
    rs.closed_s.erase(rs.closed_s.begin(), rs.closed_s.begin() + np);
    rs.closed_e.erase(rs.closed_e.begin(), rs.closed_e.begin() + np);
  }
  // phase 1: all records with pos < t_hi
  for (;;) {
    int32_t pos; const uint8_t* q; uint32_t bs;
    int r = rs_peek(rs, &pos, &q, &bs);
    if (r < 0) return r;
    if (r == 0 || (int64_t)pos >= t_hi) break;
    int rc = rs_stage(rs, q, bs);
    if (rc < 0) return rc;
    if (rs.batch.size() >= 8192) {
      rc = rs_flush(rs);
      if (rc < 0) return rc;
    }
  }
  {
    int rc = rs_flush(rs);
    if (rc < 0) return rc;
  }
  // the set is now fixed: members overlap [t_lo, t_hi) by trimmed bounds
  // (plus, under extract_mode, the earlier-order past-boundary records)
  int64_t e_set = -1, max_order = -1;
  for (auto& cr : rs.carry)
    if (cr.aln_t_s < t_hi && cr.aln_t_e >= t_lo) {
      if (cr.aln_t_e > e_set) e_set = cr.aln_t_e;
      if (cr.order > max_order) max_order = cr.order;
    }
  auto in_set = [&](const CarryRec& cr) {
    if (cr.aln_t_s < t_hi && cr.aln_t_e >= t_lo) return true;
    return extract_mode != 0 && cr.aln_t_s >= t_hi && cr.order <= max_order;
  };
  if (extract_mode)
    for (auto& cr : rs.carry)
      if (in_set(cr) && cr.aln_t_e > e_set) e_set = cr.aln_t_e;
  // phase 2: clip-verdict lookahead (see header comment for the proof)
  int64_t need_frontier = e_set + 2 * rs.clip_margin + 32;
  for (;;) {
    int32_t pos; const uint8_t* q; uint32_t bs;
    int r = rs_peek(rs, &pos, &q, &bs);
    if (r < 0) return r;
    if (r == 0 || (int64_t)pos >= need_frontier) break;
    int rc = rs_stage(rs, q, bs);
    if (rc < 0) return rc;
    if (rs.batch.size() >= 8192) {
      rc = rs_flush(rs);
      if (rc < 0) return rc;
    }
  }
  {
    int rc = rs_flush(rs);
    if (rc < 0) return rc;
  }
  rs.set.clear();
  rs.set_stream = 0;
  int64_t mn = t_lo, mx = t_lo;
  for (auto& cr : rs.carry) {
    if (in_set(cr)) {
      rs_decide_clip(rs, cr);
      rs.set.push_back(&cr);
      rs.set_stream += (int64_t)cr.t.size();
      if (cr.aln_t_s < mn) mn = cr.aln_t_s;
      if (cr.aln_t_e > mx) mx = cr.aln_t_e;
    }
  }
  rs.base = mn;
  rs.maxt = mx;
  *stream_n = rs.set_stream;
  *reads_n = (int64_t)rs.set.size();
  *base_out = mn;
  *maxt_out = mx;
  return 0;
}

// Fill caller buffers for the pending set: tag streams rebased to the
// reported base, per-read stream offsets, rebased bounds, clip-filter drop
// flags, raw clip labels and global orders.
int np2_range_fetch(void* handle, int32_t* t_pos_out, int32_t* key_out,
                    int64_t* read_start_out, int64_t* aln_bounds_out,
                    uint8_t* clip_drop_out, uint8_t* clip_label_out,
                    int64_t* orders_out) {
  RangeScan& rs = *static_cast<RangeScan*>(handle);
  int64_t off = 0;
  int32_t b = (int32_t)rs.base;
  for (size_t i = 0; i < rs.set.size(); i++) {
    CarryRec& cr = *rs.set[i];
    read_start_out[i] = off;
    aln_bounds_out[2 * i] = cr.aln_t_s - rs.base;
    aln_bounds_out[2 * i + 1] = cr.aln_t_e - rs.base;
    clip_drop_out[i] = cr.drop;
    clip_label_out[i] = cr.clip;
    orders_out[i] = cr.order;
    size_t n = cr.t.size();
    const int32_t* tp = cr.t.data();
    int32_t* to = t_pos_out + off;
    for (size_t j = 0; j < n; j++) to[j] = tp[j] - b;
    memcpy(key_out + off, cr.k.data(), n * 4);
    off += (int64_t)n;
  }
  return 0;
}

}  // extern "C"
