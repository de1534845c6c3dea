/* CPython extension: fast LqSeq object type, bulk builder and the LQ
 * stage's per-region loops.
 *
 * The LQ candidate-allele stage (reference hot loop 3, main.rs:1440-1523)
 * materializes ~150k LqSeq records per 100 kb contig iteration. Constructing
 * them through the Python dataclass costs ~1.7 us each (ceval + boxing of
 * u64 hashes); this module provides (a) a C slot type with the same four
 * attributes (order, kscore, kmer, seq — kscore/kmer/seq writable, matching
 * how retrieve_kmer_count and mark_hete mutate them) and (b) build_lqseqs(),
 * which creates the objects straight from the native extraction pass's
 * output arrays and appends them to the per-region seqs lists in one C loop.
 *
 * Each routine below is one C loop over every region of a contig, the twin
 * of a Python body in models/oracle_lq.py that stays the executable spec:
 *   collect_score_jobs, assign_kscores  retrieve_kmer_count's loops
 *   seed_regions                         _fill_seed_lqseqs_py
 *   mark_hete                            _mark_hete_lqseqs_py
 *   splice_labeled                       _update_consensus_with_lqseqs_py
 * seed_regions and mark_hete share allele_stats, the twin of
 * fill_order_stat (main.rs:813-849).
 *
 * models/oracle_lq.py keeps the @dataclass twin as the executable spec and
 * falls back to it when this module is unavailable, or when a routine
 * raises TypeError (dataclass LqSeqs, or data the spec handles by raising
 * its own error); the routines raise it before they change anything.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <structmember.h>
#include <stdint.h>
#include <string.h>

typedef struct {
    PyObject_HEAD
    long long order;
    long long kscore;
    unsigned long long kmer;
    PyObject *seq; /* bytes */
} LqSeqObj;

static void LqSeq_dealloc(LqSeqObj *self) {
    Py_XDECREF(self->seq);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static int LqSeq_init(LqSeqObj *self, PyObject *args, PyObject *kwds) {
    static char *kwlist[] = {"order", "kscore", "kmer", "seq", NULL};
    PyObject *seq = NULL;
    if (!PyArg_ParseTupleAndKeywords(args, kwds, "LLKO", kwlist, &self->order,
                                     &self->kscore, &self->kmer, &seq))
        return -1;
    Py_INCREF(seq);
    Py_XSETREF(self->seq, seq);
    return 0;
}

static PyObject *LqSeq_repr(LqSeqObj *self) {
    return PyUnicode_FromFormat("LqSeq(order=%lld, kscore=%lld, kmer=%llu, seq=%R)",
                                self->order, self->kscore, self->kmer,
                                self->seq ? self->seq : Py_None);
}

static PyMemberDef LqSeq_members[] = {
    {"order", T_LONGLONG, offsetof(LqSeqObj, order), 0, "alignment index"},
    {"kscore", T_LONGLONG, offsetof(LqSeqObj, kscore), 0, "min yak count"},
    {"kmer", T_ULONGLONG, offsetof(LqSeqObj, kmer), 0, "full yak hash or INVALID"},
    {"seq", T_OBJECT_EX, offsetof(LqSeqObj, seq), 0, "allele bytes"},
    {NULL},
};

static PyTypeObject LqSeqType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "np2obj.LqSeq",
    .tp_basicsize = sizeof(LqSeqObj),
    .tp_dealloc = (destructor)LqSeq_dealloc,
    .tp_repr = (reprfunc)LqSeq_repr,
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_doc = "Candidate allele of an LQ interval (C twin of the "
              "oracle_lq.LqSeq dataclass spec)",
    .tp_members = LqSeq_members,
    .tp_init = (initproc)LqSeq_init,
    .tp_new = PyType_GenericNew,
};

/* build_lqseqs(sinks, region_i32, order_i32, kmer_u64, has_u8, soff_i64,
 *              seq_bytes, invalid) -> None
 * sinks: list (len R) of the per-region seqs lists. Entry i appends
 * LqSeq(order[i], 0, has[i] ? kmer[i] : invalid, seq_bytes[soff[i]:soff[i+1]])
 * to sinks[region[i]]. All arrays are C-contiguous little-endian buffers. */
static PyObject *build_lqseqs(PyObject *self, PyObject *args) {
    PyObject *sinks;
    Py_buffer region, order, kmer, has, soff, seqb;
    unsigned long long invalid;
    if (!PyArg_ParseTuple(args, "O!y*y*y*y*y*y*K", &PyList_Type, &sinks,
                          &region, &order, &kmer, &has, &soff, &seqb,
                          &invalid))
        return NULL;
    PyObject *ret = NULL;
    Py_ssize_t M = region.len / 4;
    if (order.len != 4 * M || kmer.len != 8 * M || has.len != M ||
        soff.len != 8 * (M + 1)) {
        PyErr_SetString(PyExc_ValueError, "build_lqseqs: array length mismatch");
        goto done;
    }
    {
        const int32_t *reg = (const int32_t *)region.buf;
        const int32_t *ord = (const int32_t *)order.buf;
        const uint64_t *km = (const uint64_t *)kmer.buf;
        const uint8_t *hs = (const uint8_t *)has.buf;
        const int64_t *so = (const int64_t *)soff.buf;
        const char *sb = (const char *)seqb.buf;
        Py_ssize_t R = PyList_GET_SIZE(sinks);
        for (Py_ssize_t i = 0; i < M; i++) {
            int32_t r = reg[i];
            int64_t s0 = so[i], s1 = so[i + 1];
            if (r < 0 || r >= R || s0 < 0 || s1 < s0 || s1 > seqb.len) {
                PyErr_SetString(PyExc_ValueError, "build_lqseqs: bad index");
                goto done;
            }
            LqSeqObj *o = PyObject_New(LqSeqObj, &LqSeqType);
            if (!o) goto done;
            o->order = ord[i];
            o->kscore = 0;
            o->kmer = hs[i] ? km[i] : invalid;
            o->seq = PyBytes_FromStringAndSize(sb + s0, s1 - s0);
            if (!o->seq) { Py_DECREF(o); goto done; }
            PyObject *lst = PyList_GET_ITEM(sinks, r);
            if (!PyList_Check(lst)) {
                Py_DECREF(o);
                PyErr_SetString(PyExc_TypeError, "build_lqseqs: sink not a list");
                goto done;
            }
            int rc = PyList_Append(lst, (PyObject *)o);
            Py_DECREF(o);
            if (rc < 0) goto done;
        }
    }
    Py_INCREF(Py_None);
    ret = Py_None;
done:
    PyBuffer_Release(&region);
    PyBuffer_Release(&order);
    PyBuffer_Release(&kmer);
    PyBuffer_Release(&has);
    PyBuffer_Release(&soff);
    PyBuffer_Release(&seqb);
    return ret;
}

/* collect_score_jobs(lqseqs, ksize, invalid)
 *   -> (long_refs, long_seqs, single_refs, single_hashes)
 * One C pass over every region's seqs list partitioning alleles for
 * retrieve_kmer_count (main.rs:740-778 batching): len(seq) > ksize alleles
 * go to the batched rolling-scan lists; <= ksize alleles with a valid
 * precomputed hash go to the single-hash lists. The equivalent Python loop
 * costs ~0.14 s per 100 kb iteration (~300k list appends + attribute
 * loads); raises TypeError when an item is not the C LqSeq (the dataclass
 * spec path) so the caller can fall back to the Python loop. */
static PyObject *collect_score_jobs(PyObject *self, PyObject *args) {
    PyObject *lqseqs;
    long long ksize;
    unsigned long long invalid;
    if (!PyArg_ParseTuple(args, "OLK", &lqseqs, &ksize, &invalid))
        return NULL;
    PyObject *seq_lists = PySequence_Fast(lqseqs, "lqseqs not a sequence");
    if (!seq_lists) return NULL;
    PyObject *long_refs = PyList_New(0), *long_seqs = PyList_New(0);
    PyObject *single_refs = PyList_New(0), *single_hashes = PyList_New(0);
    PyObject *ret = NULL;
    if (!long_refs || !long_seqs || !single_refs || !single_hashes) goto done;
    {
        Py_ssize_t R = PySequence_Fast_GET_SIZE(seq_lists);
        for (Py_ssize_t r = 0; r < R; r++) {
            PyObject *region = PySequence_Fast_GET_ITEM(seq_lists, r);
            PyObject *seqs = PyObject_GetAttrString(region, "seqs");
            if (!seqs) goto done;
            if (!PyList_Check(seqs)) {
                Py_DECREF(seqs);
                PyErr_SetString(PyExc_TypeError, "seqs not a list");
                goto done;
            }
            Py_ssize_t S = PyList_GET_SIZE(seqs);
            for (Py_ssize_t i = 0; i < S; i++) {
                PyObject *item = PyList_GET_ITEM(seqs, i);
                if (!PyObject_TypeCheck(item, &LqSeqType)) {
                    Py_DECREF(seqs);
                    PyErr_SetString(PyExc_TypeError, "not a C LqSeq");
                    goto done;
                }
                LqSeqObj *o = (LqSeqObj *)item;
                Py_ssize_t slen = PyBytes_Check(o->seq)
                    ? PyBytes_GET_SIZE(o->seq) : PyObject_Length(o->seq);
                if (slen < 0) {  /* length-less seq: propagate, don't
                                    misclassify with an exception pending */
                    Py_DECREF(seqs);
                    goto done;
                }
                int rc = 0;
                if (slen > ksize) {
                    rc = PyList_Append(long_refs, item) < 0
                        || PyList_Append(long_seqs, o->seq) < 0;
                } else if (o->kmer != invalid) {
                    PyObject *h = PyLong_FromUnsignedLongLong(o->kmer);
                    rc = !h || PyList_Append(single_refs, item) < 0
                        || PyList_Append(single_hashes, h) < 0;
                    Py_XDECREF(h);
                }
                if (rc) { Py_DECREF(seqs); goto done; }
            }
            Py_DECREF(seqs);
        }
    }
    ret = PyTuple_Pack(4, long_refs, long_seqs, single_refs, single_hashes);
done:
    Py_XDECREF(long_refs);
    Py_XDECREF(long_seqs);
    Py_XDECREF(single_refs);
    Py_XDECREF(single_hashes);
    Py_DECREF(seq_lists);
    return ret;
}

/* assign_kscores(refs, scores_i64_buffer) -> None
 * refs[i].kscore = scores[i] in one C loop (the zip-assign twin). */
static PyObject *assign_kscores(PyObject *self, PyObject *args) {
    PyObject *refs;
    Py_buffer scores;
    if (!PyArg_ParseTuple(args, "O!y*", &PyList_Type, &refs, &scores))
        return NULL;
    Py_ssize_t n = PyList_GET_SIZE(refs);
    PyObject *ret = NULL;
    if (scores.len != 8 * n) {
        PyErr_SetString(PyExc_ValueError, "assign_kscores: length mismatch");
        goto done;
    }
    {
        const int64_t *sc = (const int64_t *)scores.buf;
        for (Py_ssize_t i = 0; i < n; i++) {
            PyObject *item = PyList_GET_ITEM(refs, i);
            if (!PyObject_TypeCheck(item, &LqSeqType)) {
                PyErr_SetString(PyExc_TypeError, "not a C LqSeq");
                goto done;
            }
            ((LqSeqObj *)item)->kscore = sc[i];
        }
    }
    Py_INCREF(Py_None);
    ret = Py_None;
done:
    PyBuffer_Release(&scores);
    return ret;
}

/* ---- the seed pass: seed_regions, mark_hete, splice_labeled ---------- */

/* label bits (main.rs:655-658) */
#define L_SUCC 0x80LL
#define L_HETE 0x40LL
#define L_RECH 0x20LL

static PyObject *s_seqs, *s_label, *s_sudoseed, *s_start, *s_end;

/* Scratch for one region of at most cap alleles, reused region to region.
 * Positions index the region's seqs list; groups are its distinct allele
 * bytes in order of first occurrence. */
typedef struct {
    int *grp;        /* group of each position */
    int *suffix;     /* members of its group at or after each position */
    int *rep;        /* per group: its first position */
    int *gcnt;       /* per group: running member count */
    int *head;       /* per group: first member with kscore > 0, or -1 */
    int *stat;       /* per position: fill_order_stat's stats[p] */
    int *perm;       /* stable sort order */
    uint64_t *ghash; /* per group: hash of its bytes */
    long long *skey; /* per position: order_stat.get(order, 0) */
    long long *okey; /* order_stat's keys (read orders) ... */
    long long *oval; /* ... and counts */
    PyObject **tmp;  /* the reordered list items */
    int nkeys;
} Scratch;

static int scratch_init(Scratch *w, Py_ssize_t cap) {
    size_t n = (size_t)(cap > 0 ? cap : 1) + 2;
    memset(w, 0, sizeof(*w));
    w->grp = PyMem_Malloc(7 * n * sizeof(int));
    w->ghash = PyMem_Malloc(n * sizeof(uint64_t));
    w->skey = PyMem_Malloc(3 * n * sizeof(long long));
    w->tmp = PyMem_Malloc(n * sizeof(PyObject *));
    if (!w->grp || !w->ghash || !w->skey || !w->tmp) {
        PyMem_Free(w->grp); PyMem_Free(w->ghash);
        PyMem_Free(w->skey); PyMem_Free(w->tmp);
        PyErr_NoMemory();
        return -1;
    }
    w->suffix = w->grp + n;
    w->rep = w->grp + 2 * n;
    w->gcnt = w->grp + 3 * n;
    w->head = w->grp + 4 * n;
    w->stat = w->grp + 5 * n;
    w->perm = w->grp + 6 * n;
    w->okey = w->skey + n;
    w->oval = w->skey + 2 * n;
    return 0;
}

static void scratch_free(Scratch *w) {
    PyMem_Free(w->grp);
    PyMem_Free(w->ghash);
    PyMem_Free(w->skey);
    PyMem_Free(w->tmp);
}

/* order_stat: a dict of at most cap + 2 keys, searched linearly */
static int os_find(const Scratch *w, long long key) {
    for (int k = 0; k < w->nkeys; k++)
        if (w->okey[k] == key) return k;
    return -1;
}

static void os_set(Scratch *w, long long key, long long v) {
    int k = os_find(w, key);
    if (k < 0) {
        k = w->nkeys++;
        w->okey[k] = key;
    }
    w->oval[k] = v;
}

static long long os_get(const Scratch *w, long long key) {
    int k = os_find(w, key);
    return k < 0 ? 0 : w->oval[k];
}

static uint64_t bytes_hash(const unsigned char *b, Py_ssize_t n) {
    uint64_t h = 1469598103934665603ULL ^ (uint64_t)n;
    for (Py_ssize_t i = 0; i < n; i++) {
        h ^= b[i];
        h *= 1099511628211ULL;
    }
    return h;
}

typedef struct { int max1_c, max1_p, max2_c, max2_p; } Top2;

/* fill_order_stat (main.rs:813-849) over one region's S alleles: groups
 * them by their bytes, then scans in list order, skipping an allele with
 * kscore <= 0 or one whose group is already counted; a counted group's
 * count is its members at or after the first position (stats), keyed by
 * that allele's read order (order_stat); the top two break ties as the
 * reference does. Allocates no Python object. */
static void allele_stats(LqSeqObj **it, int S, Scratch *w, Top2 *t) {
    int ng = 0;
    for (int p = 0; p < S; p++) {
        PyObject *sq = it[p]->seq;
        const char *b = PyBytes_AS_STRING(sq);
        Py_ssize_t n = PyBytes_GET_SIZE(sq);
        uint64_t h = bytes_hash((const unsigned char *)b, n);
        int g = 0;
        for (; g < ng; g++) {
            PyObject *r = it[w->rep[g]]->seq;
            if (w->ghash[g] == h && PyBytes_GET_SIZE(r) == n &&
                (r == sq || memcmp(PyBytes_AS_STRING(r), b, n) == 0))
                break;
        }
        if (g == ng) {
            w->rep[ng] = p;
            w->ghash[ng] = h;
            ng++;
        }
        w->grp[p] = g;
    }
    for (int g = 0; g < ng; g++) {
        w->head[g] = -1;
        w->gcnt[g] = 0;
    }
    for (int p = S - 1; p >= 0; p--)
        w->suffix[p] = ++w->gcnt[w->grp[p]];
    w->nkeys = 0;
    int m1c = 0, m1p = 0, m2c = 0, m2p = 0;
    for (int p1 = 0; p1 < S; p1++) {
        if (it[p1]->kscore <= 0) continue;
        int g = w->grp[p1];
        if (w->head[g] >= 0) continue; /* stats[p1] > 0: already counted */
        w->head[g] = p1;
        int c = w->suffix[p1];
        os_set(w, it[p1]->order, c);
        if (c > m1c || (c == m1c && it[p1]->order == 0)) {
            m2c = m1c;
            m2p = m1p;
            m1c = c;
            m1p = p1;
        } else if (m1p == m2p || c > m2c) {
            m2c = c;
            m2p = p1;
        }
    }
    for (int p = 0; p < S; p++) {
        int hd = w->head[w->grp[p]];
        w->stat[p] = (hd >= 0 && p >= hd) ? w->suffix[hd] : 0;
    }
    t->max1_c = m1c;
    t->max1_p = m1p;
    t->max2_c = m2c;
    t->max2_p = m2p;
}

static int min_count(Py_ssize_t c) { /* get_min_count, main.rs:803-811 */
    return c >= 9 ? 3 : c >= 6 ? 2 : 1;
}

/* is_valid_snp (main.rs:780-801): homopolymer-compressed inequality */
static int valid_snp(PyObject *a, PyObject *b) {
    const char *s1 = PyBytes_AS_STRING(a), *s2 = PyBytes_AS_STRING(b);
    Py_ssize_t n1 = PyBytes_GET_SIZE(a), n2 = PyBytes_GET_SIZE(b);
    Py_ssize_t i = 0, j = 0;
    while (i < n1 && j < n2) {
        if (s1[i] != s2[j]) return 1;
        while (i + 1 < n1 && s1[i] == s1[i + 1]) i++;
        while (j + 1 < n2 && s2[j] == s2[j + 1]) j++;
        i++;
        j++;
    }
    return 0;
}

/* An int attribute; TypeError where it is none. */
static int int_attr(PyObject *o, PyObject *name, long long *out) {
    PyObject *v = PyObject_GetAttr(o, name);
    if (!v) return -1;
    *out = PyLong_Check(v) ? PyLong_AsLongLong(v) : -1;
    int bad = !PyLong_Check(v) || (*out == -1 && PyErr_Occurred());
    Py_DECREF(v);
    if (bad) {
        PyErr_Clear();
        PyErr_SetString(PyExc_TypeError, "not an int");
        return -1;
    }
    return 0;
}

/* One region's seqs list (a new reference) and label. TypeError unless
 * seqs is a list of at most max_can C LqSeqs whose seq is bytes and label
 * an int; with need_ref, also unless the list is led by order 0 (the
 * spec then raises its own error). */
static PyObject *region_seqs(PyObject *region, Py_ssize_t max_can,
                             int need_ref, long long *label) {
    if (int_attr(region, s_label, label) < 0) return NULL;
    PyObject *lst = PyObject_GetAttr(region, s_seqs);
    if (!lst) return NULL;
    const char *why = NULL;
    if (!PyList_Check(lst)) {
        why = "seqs not a list";
    } else {
        Py_ssize_t S = PyList_GET_SIZE(lst);
        if (S > max_can) why = "more than max_can alleles";
        for (Py_ssize_t i = 0; !why && i < S; i++) {
            PyObject *o = PyList_GET_ITEM(lst, i);
            if (!PyObject_TypeCheck(o, &LqSeqType))
                why = "not a C LqSeq";
            else if (!((LqSeqObj *)o)->seq || !PyBytes_Check(((LqSeqObj *)o)->seq))
                why = "seq not bytes";
        }
        if (!why && need_ref &&
            (S == 0 || ((LqSeqObj *)PyList_GET_ITEM(lst, 0))->order != 0))
            why = "the first lqseq is not ref";
    }
    if (why) {
        Py_DECREF(lst);
        PyErr_SetString(PyExc_TypeError, why);
        return NULL;
    }
    return lst;
}

/* The regions as a sequence (a new reference), each checked as
 * region_seqs does before anything changes, and w set up for max_can
 * alleles; NULL on error. */
static PyObject *walk_begin(PyObject *lqseqs, Py_ssize_t max_can,
                            int need_ref, Scratch *w) {
    PyObject *fast = PySequence_Fast(lqseqs, "lqseqs not a sequence");
    if (!fast) return NULL;
    Py_ssize_t R = PySequence_Fast_GET_SIZE(fast);
    for (Py_ssize_t r = 0; r < R; r++) {
        long long label;
        PyObject *lst = region_seqs(PySequence_Fast_GET_ITEM(fast, r),
                                    max_can, need_ref, &label);
        if (!lst) {
            Py_DECREF(fast);
            return NULL;
        }
        Py_DECREF(lst);
    }
    if (scratch_init(w, max_can) < 0) {
        Py_DECREF(fast);
        return NULL;
    }
    return fast;
}

/* An error once regions have changed is no TypeError: the caller's
 * fallback would run the spec over half-changed regions. */
static void not_a_fallback(void) {
    if (PyErr_ExceptionMatches(PyExc_TypeError)) {
        PyObject *et, *ev, *tb;
        PyErr_Fetch(&et, &ev, &tb);
        PyErr_Format(PyExc_RuntimeError, "seed pass: %S", ev ? ev : Py_None);
        Py_XDECREF(et);
        Py_XDECREF(ev);
        Py_XDECREF(tb);
    }
}

static int set_label(PyObject *region, long long label) {
    PyObject *v = PyLong_FromLongLong(label);
    if (!v) return -1;
    int rc = PyObject_SetAttr(region, s_label, v);
    Py_DECREF(v);
    return rc;
}

/* seed_regions(lqseqs, max_indel_len, max_can) -> None
 * _fill_seed_lqseqs_py (main.rs:862-914) over every region: the seed is
 * the top allele, SUCC|RECH set, the reference allele protected, the
 * alleles stably sorted by their order_stat count, descending, and cut
 * in place at the first below get_min_count; a region left with one
 * allele or none, or whose seed's length is more than max_indel_len from
 * the first allele's, takes that allele as its seed, loses RECH and gets
 * a new empty seqs list (the old list, which rebasing proxies may share,
 * keeps what the cut left). TypeError, before any change, where a region
 * is not as region_seqs requires. */
static PyObject *seed_regions(PyObject *self, PyObject *args) {
    PyObject *lqseqs;
    long long max_indel_len;
    Py_ssize_t max_can;
    if (!PyArg_ParseTuple(args, "OLn", &lqseqs, &max_indel_len, &max_can))
        return NULL;
    Scratch w;
    PyObject *fast = walk_begin(lqseqs, max_can, 1, &w);
    if (!fast) return NULL;
    PyObject *ret = NULL;
    Py_ssize_t R = PySequence_Fast_GET_SIZE(fast);
    for (Py_ssize_t r = 0; r < R; r++) {
        PyObject *region = PySequence_Fast_GET_ITEM(fast, r);
        long long label;
        PyObject *lst = region_seqs(region, max_can, 1, &label);
        if (!lst) goto fail;
        int S = (int)PyList_GET_SIZE(lst);
        LqSeqObj **it = (LqSeqObj **)PySequence_Fast_ITEMS(lst);
        Top2 t;
        allele_stats(it, S, &w, &t);
        PyObject *seed = it[t.max1_p]->seq;
        Py_INCREF(seed);
        label |= L_SUCC | L_RECH;
        int min_c = min_count(S);

        /* protect the reference allele (main.rs:877-890) */
        int k0 = os_find(&w, 0);
        if (k0 >= 0) {
            if (1 < w.oval[k0] && w.oval[k0] < min_c) w.oval[k0] = min_c;
        } else if (w.suffix[0] > 1) {
            os_set(&w, 0, min_c);
        }
        int nodup = 1; /* no_dupseq_lqseq: no repeat after position 0 */
        for (int p = 1; p < S && nodup; p++)
            if (w.suffix[p] > 1) nodup = 0;
        if (t.max1_p != 0 && t.max1_c < min_c && (t.max1_c > 1 || nodup)) {
            os_set(&w, it[t.max1_p]->order, min_c);
            os_set(&w, 0, min_c);
        } else if (t.max1_c < min_c) {
            os_set(&w, 0, min_c);
        }

        /* retain_sort_seqs (main.rs:714-727): stable sort, count desc */
        for (int p = 0; p < S; p++) {
            w.skey[p] = os_get(&w, it[p]->order);
            w.perm[p] = p;
        }
        for (int i = 1; i < S; i++) {
            int v = w.perm[i], j = i;
            while (j > 0 && w.skey[w.perm[j - 1]] < w.skey[v]) {
                w.perm[j] = w.perm[j - 1];
                j--;
            }
            w.perm[j] = v;
        }
        int keep = 0;
        while (keep < S && w.skey[w.perm[keep]] >= min_c) keep++;
        for (int i = 0; i < S; i++) w.tmp[i] = (PyObject *)it[w.perm[i]];
        memcpy(it, w.tmp, (size_t)S * sizeof(PyObject *));
        if (keep < S && PyList_SetSlice(lst, keep, S, NULL) < 0) {
            Py_DECREF(seed);
            Py_DECREF(lst);
            goto fail;
        }
        S = keep;
        it = (LqSeqObj **)PySequence_Fast_ITEMS(lst);

        int skip_long = 0;
        if (S > 0) {
            long long d = (long long)PyBytes_GET_SIZE(seed)
                - (long long)PyBytes_GET_SIZE(it[0]->seq);
            skip_long = (d < 0 ? -d : d) > max_indel_len;
        }
        int clear = S <= 1 || skip_long;
        if (clear) {
            if (S > 0) {
                Py_SETREF(seed, it[0]->seq);
                Py_INCREF(seed);
            }
            label &= ~L_RECH;
        }
        Py_DECREF(lst);
        int rc = PyObject_SetAttr(region, s_sudoseed, seed);
        Py_DECREF(seed);
        if (rc < 0 || set_label(region, label) < 0) goto fail;
        if (clear) {
            PyObject *empty = PyList_New(0);
            if (!empty) goto fail;
            rc = PyObject_SetAttr(region, s_seqs, empty);
            Py_DECREF(empty);
            if (rc < 0) goto fail;
        }
    }
    Py_INCREF(Py_None);
    ret = Py_None;
    goto done;
fail:
    not_a_fallback();
done:
    scratch_free(&w);
    Py_DECREF(fast);
    return ret;
}

/* mark_hete(lqseqs, max_can) -> int
 * _mark_hete_lqseqs_py (main.rs:916-946) over every region: where the
 * second allele has at least get_min_count members, matches the first in
 * length (or, over 5 alleles, has half its count) and differs from it
 * under homopolymer compression, the region takes HETE and every allele
 * with kscore > 0 and fewer members than that count gets kscore 0.
 * Returns the regions marked. TypeError, before any change, as in
 * seed_regions (without the order-0 check). */
static PyObject *mark_hete(PyObject *self, PyObject *args) {
    PyObject *lqseqs;
    Py_ssize_t max_can;
    if (!PyArg_ParseTuple(args, "On", &lqseqs, &max_can)) return NULL;
    Scratch w;
    PyObject *fast = walk_begin(lqseqs, max_can, 0, &w);
    if (!fast) return NULL;
    PyObject *ret = NULL;
    long long het = 0;
    Py_ssize_t R = PySequence_Fast_GET_SIZE(fast);
    for (Py_ssize_t r = 0; r < R; r++) {
        PyObject *region = PySequence_Fast_GET_ITEM(fast, r);
        long long label;
        PyObject *lst = region_seqs(region, max_can, 0, &label);
        if (!lst) goto fail;
        int S = (int)PyList_GET_SIZE(lst);
        LqSeqObj **it = (LqSeqObj **)PySequence_Fast_ITEMS(lst);
        Top2 t;
        allele_stats(it, S, &w, &t);
        int min_c = min_count(S);
        if (t.max2_c >= min_c) {
            PyObject *s1 = it[t.max1_p]->seq, *s2 = it[t.max2_p]->seq;
            if ((PyBytes_GET_SIZE(s1) == PyBytes_GET_SIZE(s2)
                 || (S >= 6 && t.max2_c >= t.max1_c / 2))
                && valid_snp(s1, s2)) {
                if (set_label(region, label | L_HETE) < 0) {
                    Py_DECREF(lst);
                    goto fail;
                }
                for (int p = 0; p < S; p++)
                    if (it[p]->kscore > 0 && w.stat[p] < min_c)
                        it[p]->kscore = 0;
                het++;
            }
        }
        Py_DECREF(lst);
    }
    ret = PyLong_FromLongLong(het);
    goto done;
fail:
    not_a_fallback();
done:
    scratch_free(&w);
    Py_DECREF(fast);
    return ret;
}

/* _next_labeled: the next index below i whose label has a bit of `label`,
 * -1 for none; -2 on error */
static Py_ssize_t next_labeled(PyObject *fast, Py_ssize_t i, long long label) {
    for (i--; i >= 0; i--) {
        long long v;
        if (int_attr(PySequence_Fast_GET_ITEM(fast, i), s_label, &v) < 0)
            return -2;
        if (v & label) return i;
    }
    return -1;
}

/* One walk of the splice over the regions from the tail (ascending genome
 * order). Each region with a bit of `label` replaces the consensus entries
 * from its start (found by binary search at or after the cursor) through
 * its end by its sudoseed, every base of it at pos = start; the walk stops
 * at a region whose start is absent there. With OP and OB NULL it sums the
 * output length into *out and, with count_changed, counts in *changed the
 * splices whose seed differs from the bytes replaced; otherwise it writes
 * the output. -1 on error: TypeError where a region lacks an int label,
 * start or end or a bytes sudoseed. */
static int splice_walk(PyObject *fast, long long label, const int64_t *P,
                       const char *B, Py_ssize_t n, int count_changed,
                       int64_t *OP, char *OB, Py_ssize_t *out,
                       long long *changed) {
    Py_ssize_t c = 0, o = 0;
    Py_ssize_t li = next_labeled(fast, PySequence_Fast_GET_SIZE(fast), label);
    while (li >= 0 && c < n) {
        PyObject *region = PySequence_Fast_GET_ITEM(fast, li);
        long long start, end;
        if (int_attr(region, s_start, &start) < 0
            || int_attr(region, s_end, &end) < 0)
            return -1;
        Py_ssize_t lo = c, hi = n; /* first pos >= start in [c, n) */
        while (lo < hi) {
            Py_ssize_t m = lo + (hi - lo) / 2;
            if (P[m] < start) lo = m + 1; else hi = m;
        }
        Py_ssize_t i0 = lo;
        if (i0 >= n || P[i0] != start) break;
        lo = 0, hi = n; /* first pos > end in [0, n) */
        while (lo < hi) {
            Py_ssize_t m = lo + (hi - lo) / 2;
            if (P[m] <= end) lo = m + 1; else hi = m;
        }
        PyObject *seed = PyObject_GetAttr(region, s_sudoseed);
        if (!seed) return -1;
        if (!PyBytes_Check(seed)) {
            Py_DECREF(seed);
            PyErr_SetString(PyExc_TypeError, "sudoseed not bytes");
            return -1;
        }
        const char *sb = PyBytes_AS_STRING(seed);
        Py_ssize_t sl = PyBytes_GET_SIZE(seed);
        if (OP) {
            memcpy(OP + o, P + c, (size_t)(i0 - c) * 8);
            memcpy(OB + o, B + c, (size_t)(i0 - c));
            for (Py_ssize_t j = 0; j < sl; j++) OP[o + i0 - c + j] = start;
            memcpy(OB + o + i0 - c, sb, (size_t)sl);
        } else if (count_changed) {
            Py_ssize_t had = lo > i0 ? lo - i0 : 0;
            if (had != sl || memcmp(B + i0, sb, (size_t)sl)) ++*changed;
        }
        Py_DECREF(seed);
        o += (i0 - c) + sl;
        c = lo;
        li = next_labeled(fast, li, label);
    }
    if (li == -2) return -1;
    if (OP) {
        memcpy(OP + o, P + c, (size_t)(n - c) * 8);
        memcpy(OB + o, B + c, (size_t)(n - c));
    }
    *out = o + (n - c);
    return 0;
}

/* splice_labeled(lqseqs, label, pos_i64, base_u8, count_changed)
 *   -> (pos bytearray, base bytearray, changed)
 * _update_consensus_with_lqseqs_py (main.rs:1027-1058) in two walks
 * (splice_walk): the first finds each labelled region's index range and
 * sums the output length, the second writes int64 positions and uint8
 * bases once into buffers allocated at that length. */
static PyObject *splice_labeled(PyObject *self, PyObject *args) {
    PyObject *lqseqs;
    long long label;
    Py_buffer pb, bb;
    int count_changed;
    if (!PyArg_ParseTuple(args, "OLy*y*p", &lqseqs, &label, &pb, &bb,
                          &count_changed))
        return NULL;
    PyObject *ret = NULL, *fast = NULL, *po = NULL, *bo = NULL;
    Py_ssize_t n = pb.len / 8, out = 0, wrote = 0;
    long long changed = 0;
    const int64_t *P = (const int64_t *)pb.buf;
    const char *B = (const char *)bb.buf;
    if (pb.len % 8 || bb.len != n) {
        PyErr_SetString(PyExc_ValueError, "splice_labeled: length mismatch");
        goto done;
    }
    fast = PySequence_Fast(lqseqs, "lqseqs not a sequence");
    if (!fast || splice_walk(fast, label, P, B, n, count_changed, NULL, NULL,
                             &out, &changed) < 0)
        goto done;
    po = PyByteArray_FromStringAndSize(NULL, out * 8);
    bo = PyByteArray_FromStringAndSize(NULL, out);
    if (!po || !bo
        || splice_walk(fast, label, P, B, n, 0,
                       (int64_t *)PyByteArray_AS_STRING(po),
                       PyByteArray_AS_STRING(bo), &wrote, &changed) < 0)
        goto done;
    ret = Py_BuildValue("(OOL)", po, bo, changed);
done:
    Py_XDECREF(po);
    Py_XDECREF(bo);
    Py_XDECREF(fast);
    PyBuffer_Release(&pb);
    PyBuffer_Release(&bb);
    return ret;
}

static PyMethodDef np2obj_methods[] = {
    {"build_lqseqs", build_lqseqs, METH_VARARGS,
     "Bulk-create LqSeq objects from extraction arrays into per-region lists"},
    {"collect_score_jobs", collect_score_jobs, METH_VARARGS,
     "Partition every region's alleles into batched/single scoring job lists"},
    {"assign_kscores", assign_kscores, METH_VARARGS,
     "refs[i].kscore = scores_i64[i] in one C loop"},
    {"seed_regions", seed_regions, METH_VARARGS,
     "fill_seed_lqseqs over every region in one C loop"},
    {"mark_hete", mark_hete, METH_VARARGS,
     "mark_hete_lqseqs over every region in one C loop; returns the count"},
    {"splice_labeled", splice_labeled, METH_VARARGS,
     "update_consensus_with_lqseqs's splice in one C walk"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef np2obj_module = {
    PyModuleDef_HEAD_INIT, "np2obj",
    "Fast LqSeq object type, bulk builder and the LQ stage's per-region loops (see the .c)",
    -1, np2obj_methods,
};

PyMODINIT_FUNC PyInit_np2obj(void) {
    if (PyType_Ready(&LqSeqType) < 0) return NULL;
    if (!(s_seqs = PyUnicode_InternFromString("seqs"))
        || !(s_label = PyUnicode_InternFromString("label"))
        || !(s_sudoseed = PyUnicode_InternFromString("sudoseed"))
        || !(s_start = PyUnicode_InternFromString("start"))
        || !(s_end = PyUnicode_InternFromString("end")))
        return NULL;
    PyObject *m = PyModule_Create(&np2obj_module);
    if (!m) return NULL;
    Py_INCREF(&LqSeqType);
    if (PyModule_AddObject(m, "LqSeq", (PyObject *)&LqSeqType) < 0) {
        Py_DECREF(&LqSeqType);
        Py_DECREF(m);
        return NULL;
    }
    return m;
}
