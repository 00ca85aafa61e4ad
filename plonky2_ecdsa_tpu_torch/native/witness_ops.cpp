// Native witness-tape executor kernels.
//
// The circuit template's witness tape (circuit/builder.py) is a sequence of
// vectorized ops over a value table vals[num_targets, B] (uint64, row-major).
// The numpy closures are the semantic reference; these kernels compute the
// SAME values natively (tests assert bit-identical tables).  This is the
// TPU-framework equivalent of the reference's witness-generator layer
// (src/gadgets/*.rs run_once generators) as native code: per-batch-element
// scalar bigint math, dispatched per op from Python via ctypes with
// per-op prebuilt argument tuples.
//
// Bigint representation: little-endian u32 digit arrays (capacity 24 digits
// = 768 bits, enough for 261-bit x 261-bit products + headroom).

#include <cstdint>
#include <cstring>

typedef uint32_t u32;
typedef uint64_t u64;
typedef int64_t i64;
typedef __uint128_t u128;

static const int BITS = 29;
static const u32 MASK29 = (1u << 29) - 1;
static const int NL = 9;           // 29-bit limbs per nonnative value
static const i64 CARRY_OFFSET = 1ll << 33;
static const u64 GOLD_P = 0xFFFFFFFF00000001ull;  // Goldilocks prime

// ---------------------------------------------------------------------------
// digit bigint helpers (u32 digits, little-endian, fixed capacity)
// ---------------------------------------------------------------------------

static const int CAP = 24;

struct Big {
    u32 d[CAP];
    int n;  // digits used (no trailing zeros, n >= 0; n==0 means zero)
};

static inline void big_zero(Big &a) { a.n = 0; memset(a.d, 0, sizeof(a.d)); }

static inline void big_norm(Big &a) {
    while (a.n > 0 && a.d[a.n - 1] == 0) a.n--;
}

static inline int big_cmp(const Big &a, const Big &b) {
    if (a.n != b.n) return a.n < b.n ? -1 : 1;
    for (int i = a.n - 1; i >= 0; i--)
        if (a.d[i] != b.d[i]) return a.d[i] < b.d[i] ? -1 : 1;
    return 0;
}

static inline void big_add(const Big &a, const Big &b, Big &out) {
    u64 carry = 0;
    int n = a.n > b.n ? a.n : b.n;
    for (int i = 0; i < n; i++) {
        u64 s = carry + (i < a.n ? a.d[i] : 0) + (i < b.n ? b.d[i] : 0);
        out.d[i] = (u32)s;
        carry = s >> 32;
    }
    out.n = n;
    if (carry) out.d[out.n++] = (u32)carry;
    for (int i = out.n; i < CAP; i++) out.d[i] = 0;
}

// a -= b; requires a >= b
static inline void big_sub_inplace(Big &a, const Big &b) {
    i64 borrow = 0;
    for (int i = 0; i < a.n; i++) {
        i64 t = (i64)a.d[i] - (i < b.n ? (i64)b.d[i] : 0) - borrow;
        borrow = t < 0;
        a.d[i] = (u32)(t + (borrow << 32));
    }
    big_norm(a);
}

static inline void big_mul(const Big &a, const Big &b, Big &out) {
    u64 acc[2 * CAP];
    memset(acc, 0, sizeof(acc));
    for (int i = 0; i < a.n; i++) {
        u64 carry = 0;
        for (int j = 0; j < b.n; j++) {
            u128 t = (u128)a.d[i] * b.d[j] + acc[i + j] + carry;
            acc[i + j] = (u64)(u32)t;
            carry = (u64)(t >> 32);
        }
        acc[i + b.n] += carry;
    }
    // propagate (acc entries < 2^33 at most after adds)
    u64 carry = 0;
    int n = a.n + b.n;
    for (int i = 0; i < n; i++) {
        u64 s = acc[i] + carry;
        out.d[i] = (u32)s;
        carry = s >> 32;
    }
    out.n = n;
    while (carry) { out.d[out.n++] = (u32)carry; carry >>= 32; }
    for (int i = out.n; i < CAP; i++) out.d[i] = 0;
    big_norm(out);
}

static inline int nlz32(u32 x) { return x ? __builtin_clz(x) : 32; }

// Knuth algorithm D: (q, r) = a divmod m;  m normalized inside.
static void big_divmod(const Big &a, const Big &m, Big &q, Big &r) {
    big_zero(q);
    if (big_cmp(a, m) < 0) { r = a; return; }
    if (m.n == 1) {
        u64 rem = 0;
        q.n = a.n;
        for (int i = a.n - 1; i >= 0; i--) {
            u64 cur = (rem << 32) | a.d[i];
            q.d[i] = (u32)(cur / m.d[0]);
            rem = cur % m.d[0];
        }
        big_norm(q);
        big_zero(r);
        if (rem) { r.d[0] = (u32)rem; r.n = 1; }
        return;
    }
    int s = nlz32(m.d[m.n - 1]);
    // normalized copies (u: a << s with one extra digit; v: m << s)
    u32 un[CAP + 2], vn[CAP];
    int n = m.n, mq = a.n - n;  // quotient has mq+1 digits
    memset(un, 0, sizeof(un));
    memset(vn, 0, sizeof(vn));
    for (int i = n - 1; i > 0; i--)
        vn[i] = s ? (m.d[i] << s) | (m.d[i - 1] >> (32 - s)) : m.d[i];
    vn[0] = m.d[0] << s;
    un[a.n] = s ? (a.d[a.n - 1] >> (32 - s)) : 0;
    for (int i = a.n - 1; i > 0; i--)
        un[i] = s ? (a.d[i] << s) | (a.d[i - 1] >> (32 - s)) : a.d[i];
    un[0] = a.d[0] << s;
    for (int j = mq; j >= 0; j--) {
        u64 num = ((u64)un[j + n] << 32) | un[j + n - 1];
        u64 qhat = num / vn[n - 1];
        u64 rhat = num % vn[n - 1];
        while (qhat >= (1ull << 32) ||
               qhat * vn[n - 2] > ((rhat << 32) | un[j + n - 2])) {
            qhat--;
            rhat += vn[n - 1];
            if (rhat >= (1ull << 32)) break;
        }
        // multiply-subtract
        i64 borrow = 0;
        u64 carry = 0;
        for (int i = 0; i < n; i++) {
            u128 p = (u128)qhat * vn[i] + carry;
            carry = (u64)(p >> 32);
            i64 t = (i64)un[i + j] - (i64)(u32)p - borrow;
            borrow = t < 0;
            un[i + j] = (u32)(t + (borrow << 32));
        }
        i64 t = (i64)un[j + n] - (i64)carry - borrow;
        borrow = t < 0;
        un[j + n] = (u32)(t + (borrow << 32));
        if (borrow) {  // qhat was one too large: add back
            qhat--;
            u64 c2 = 0;
            for (int i = 0; i < n; i++) {
                u64 ss = (u64)un[i + j] + vn[i] + c2;
                un[i + j] = (u32)ss;
                c2 = ss >> 32;
            }
            un[j + n] += (u32)c2;
        }
        if (j < CAP) q.d[j] = (u32)qhat;
    }
    q.n = mq + 1;
    big_norm(q);
    // denormalize remainder
    big_zero(r);
    for (int i = 0; i < n; i++)
        r.d[i] = s ? (un[i] >> s) | ((u64)un[i + 1] << (32 - s)) : un[i];
    r.n = n;
    big_norm(r);
}

// value of 29-bit limbs -> digits (direct bit placement)
static inline void from29(const u32 *x9, int nl, Big &out) {
    big_zero(out);
    for (int i = 0; i < nl; i++) {
        int bit = i * BITS, w = bit >> 5, off = bit & 31;
        u64 v = (u64)x9[i] << off;
        u64 s = (u64)out.d[w] + (u32)v;
        out.d[w] = (u32)s;
        u64 c = (s >> 32) + (v >> 32);
        for (int j = w + 1; c; j++) {
            u64 t = (u64)out.d[j] + c;
            out.d[j] = (u32)t;
            c = t >> 32;
        }
    }
    out.n = (nl * BITS + 31) / 32 + 1;
    if (out.n > CAP) out.n = CAP;
    big_norm(out);
}

static inline void to29(const Big &a, u32 *out9, int nl) {
    // extract nl 29-bit limbs
    for (int i = 0; i < nl; i++) {
        int bit = i * BITS;
        int w = bit >> 5, off = bit & 31;
        u64 lo = w < a.n ? a.d[w] : 0;
        u64 hi = (w + 1) < a.n ? a.d[w + 1] : 0;
        out9[i] = (u32)(((lo | (hi << 32)) >> off) & MASK29);
    }
}

// ---------------------------------------------------------------------------
// value-table access
// ---------------------------------------------------------------------------

static inline void load_limbs(const u64 *vals, i64 B, const i64 *tids, int nt,
                              i64 b, u32 *out, int n) {
    for (int i = 0; i < n; i++)
        out[i] = i < nt ? (u32)vals[tids[i] * B + b] : 0;
}

static inline void store_limbs(u64 *vals, i64 B, const i64 *tids, int nt,
                               i64 b, const u32 *in) {
    for (int i = 0; i < nt; i++) vals[tids[i] * B + b] = in[i];
}

// ---------------------------------------------------------------------------
// modular inverse (binary extended GCD) modulo an odd prime m (as digits)
// operands fit 9 u32 digits; uses i64-signed digit vectors for coefficients
// ---------------------------------------------------------------------------

struct SBig {  // signed big for xgcd coefficients
    Big mag;
    int neg;
};

static inline void sbig_set(SBig &a, const Big &v) { a.mag = v; a.neg = 0; }

static void sbig_sub(const SBig &a, const SBig &b, SBig &out) {
    // out = a - b
    if (a.neg == b.neg) {
        if (big_cmp(a.mag, b.mag) >= 0) {
            out.mag = a.mag;
            big_sub_inplace(out.mag, b.mag);
            out.neg = a.neg;
        } else {
            out.mag = b.mag;
            big_sub_inplace(out.mag, a.mag);
            out.neg = !a.neg;
        }
    } else {
        big_add(a.mag, b.mag, out.mag);
        out.neg = a.neg;
    }
    if (out.mag.n == 0) out.neg = 0;
}

static inline int big_is_even(const Big &a) { return a.n == 0 || !(a.d[0] & 1); }

static inline void big_halve(Big &a) {
    for (int i = 0; i < a.n; i++) {
        a.d[i] = (a.d[i] >> 1) | ((i + 1 < a.n ? a.d[i + 1] : 0) << 31);
    }
    big_norm(a);
}

// a += m (signed left operand, unsigned m)
static inline void sbig_add_big(SBig &a, const Big &m) {
    if (!a.neg) {
        Big t;
        big_add(a.mag, m, t);
        a.mag = t;
    } else if (big_cmp(a.mag, m) <= 0) {
        Big t = m;
        big_sub_inplace(t, a.mag);
        a.mag = t;
        a.neg = 0;
    } else {
        big_sub_inplace(a.mag, m);
    }
    if (a.mag.n == 0) a.neg = 0;
}

// halve a signed even value: magnitude is even regardless of sign
static inline void sbig_halve_even(SBig &a, const Big &m) {
    if (!big_is_even(a.mag)) sbig_add_big(a, m);  // value parity fix via +m (m odd)
    big_halve(a.mag);
    if (a.mag.n == 0) a.neg = 0;
}

// inv = x^-1 mod m (x reduced first; returns 0 for x == 0 mod m like the
// reference hint path, which then fails constraints).  Binary extended GCD
// for odd m with invariants x*u == a (mod m), x*v == b (mod m).
static void mod_inverse(const Big &x_in, const Big &m, Big &inv) {
    Big x, q, dummy;
    big_divmod(x_in, m, dummy, x);
    if (x.n == 0) { big_zero(inv); return; }
    Big a = x, bb = m;
    SBig u, v, t;
    big_zero(u.mag); u.mag.d[0] = 1; u.mag.n = 1; u.neg = 0;
    big_zero(v.mag); v.neg = 0;
    while (a.n != 0) {
        while (big_is_even(a)) {
            big_halve(a);
            sbig_halve_even(u, m);
        }
        while (big_is_even(bb)) {
            big_halve(bb);
            sbig_halve_even(v, m);
        }
        if (big_cmp(a, bb) >= 0) {
            big_sub_inplace(a, bb);
            sbig_sub(u, v, t);
            u = t;
        } else {
            big_sub_inplace(bb, a);
            sbig_sub(v, u, t);
            v = t;
        }
    }
    // gcd in bb (1 for prime m, x != 0); inverse is v mod m
    Big r;
    big_divmod(v.mag, m, q, r);
    if (v.neg && r.n != 0) {
        Big mm = m;
        big_sub_inplace(mm, r);
        inv = mm;
    } else {
        inv = r;
    }
}

// ---------------------------------------------------------------------------
// Goldilocks helpers
// ---------------------------------------------------------------------------

static inline u64 gmul(u64 a, u64 b) {
    u128 t = (u128)a * b;
    return (u64)(t % GOLD_P);
}

static inline u64 gadd(u64 a, u64 b) {
    u128 t = (u128)a + b;
    return (u64)(t % GOLD_P);
}

// Goldilocks reduction of any 128-bit value to its canonical residue:
// 2^64 = 2^32 - 1 and 2^96 = -1 (mod p), so lo + 2^64 (hi_lo + 2^32 hi_hi)
// = lo - hi_hi + (2^32 - 1) hi_lo.
static inline u64 gred128(u128 x) {
    const u64 EPS = 0xFFFFFFFFull;
    u64 lo = (u64)x, hi = (u64)(x >> 64);
    u64 hh = hi >> 32, hl = hi & EPS;
    u64 t0 = lo - hh;
    if (lo < hh) t0 -= EPS;          // borrow: + 2^64 - EPS = + p
    u64 t1 = hl * EPS;
    u64 t2 = t0 + t1;
    if (t2 < t1) t2 += EPS;          // carry: + 2^64 = + EPS (cannot wrap again)
    return t2 >= GOLD_P ? t2 - GOLD_P : t2;
}

// ---------------------------------------------------------------------------
// Poseidon2 permutation trace for the PoseidonGate rows (the numpy reference
// is circuit/poseidon_gate.py _host_permute_trace).  The matrices and the
// round-order constants come from that module once, through
// poseidon_set_constants; this file holds no copy of them.
// ---------------------------------------------------------------------------

static const int P2_W = 12, P2_HF = 4, P2_PR = 22, P2_TR = 30;
static const int P2_STORED = (P2_HF - 1) * P2_W + P2_PR + P2_HF * P2_W;   // 106
static u64 P2_ME[P2_W][P2_W], P2_MI[P2_W][P2_W], P2_RC[P2_TR][P2_W];
static int p2_constants_set = 0;

static inline u64 p2_sbox(u64 x) {
    u64 x2 = gred128((u128)x * x);
    u64 x4 = gred128((u128)x2 * x2);
    return gred128((u128)gred128((u128)x4 * x2) * x);
}

// out = M s; matrix entries < 2^32, so a row's sum stays below 2^100
static inline void p2_layer(const u64 M[P2_W][P2_W], const u64 *s, u64 *out) {
    for (int i = 0; i < P2_W; i++) {
        u128 acc = 0;
        for (int j = 0; j < P2_W; j++) acc += (u128)M[i][j] * s[j];
        out[i] = gred128(acc);
    }
}

// ---------------------------------------------------------------------------
// exported ops.  All take (vals, B) plus op-specific prebuilt i64 arrays.
// tid arrays are READ-resolved (read_map applied) for inputs, raw for writes.
// ---------------------------------------------------------------------------

extern "C" {

// x*y = q*m + r; writes q (9), r (9), carries b (16, offset 2^33).
// m_dig: modulus digits (u32 as i64[8..9]); m29: modulus 29-bit limbs.
int op_mul_nn(u64 *vals, i64 B, const i64 *x_t, i64 nx, const i64 *y_t, i64 ny,
              const i64 *q_t, const i64 *r_t, const i64 *b_t,
              const i64 *m_dig, i64 nmd, const i64 *m29) {
    Big m;
    big_zero(m);
    for (int i = 0; i < nmd; i++) m.d[i] = (u32)m_dig[i];
    m.n = (int)nmd;
    big_norm(m);
    for (i64 b = 0; b < B; b++) {
        u32 x9[NL], y9[NL], q9[NL], r9[NL];
        load_limbs(vals, B, x_t, (int)nx, b, x9, NL);
        load_limbs(vals, B, y_t, (int)ny, b, y9, NL);
        Big X, Y, PR, Q, R;
        from29(x9, NL, X);
        from29(y9, NL, Y);
        big_mul(X, Y, PR);
        big_divmod(PR, m, Q, R);
        to29(Q, q9, NL);
        to29(R, r9, NL);
        // conv carries (int64, exact divisibility)
        i64 prev = 0;
        u64 bw[2 * NL - 2];
        for (int i = 0; i < 2 * NL - 1; i++) {
            int lo = i - NL + 1 > 0 ? i - NL + 1 : 0;
            int hi = i + 1 < NL ? i + 1 : NL;
            i64 conv = 0;
            for (int j = lo; j < hi; j++)
                conv += m29[j] * (i64)q9[i - j] - (i64)x9[j] * (i64)y9[i - j];
            if (i < NL) conv += (i64)r9[i];
            i64 t = conv + prev;
            if (i < 2 * NL - 2) {
                if (t & MASK29) return 1;  // carry not divisible
                prev = t >> BITS;
                i64 off = prev + CARRY_OFFSET;
                if (off < 0 || off >= (1ll << 34)) return 2;
                bw[i] = (u64)off;
            } else if (t != 0) {
                return 3;  // convolution does not telescope
            }
        }
        store_limbs(vals, B, q_t, NL, b, q9);
        store_limbs(vals, B, r_t, NL, b, r9);
        for (int i = 0; i < 2 * NL - 2; i++) vals[b_t[i] * B + b] = bw[i];
    }
    return 0;
}

// x*inv = q*m + 1; writes inv (9), q (9), carries (16).
int op_inv_nn(u64 *vals, i64 B, const i64 *x_t, i64 nx, const i64 *inv_t,
              const i64 *q_t, const i64 *b_t,
              const i64 *m_dig, i64 nmd, const i64 *m29) {
    Big m;
    big_zero(m);
    for (int i = 0; i < nmd; i++) m.d[i] = (u32)m_dig[i];
    m.n = (int)nmd;
    big_norm(m);
    for (i64 b = 0; b < B; b++) {
        u32 x9[NL], inv9[NL], q9[NL], r9[NL];
        load_limbs(vals, B, x_t, (int)nx, b, x9, NL);
        Big X, I, PR, Q, R;
        from29(x9, NL, X);
        mod_inverse(X, m, I);
        to29(I, inv9, NL);
        big_mul(X, I, PR);
        big_divmod(PR, m, Q, R);
        to29(Q, q9, NL);
        to29(R, r9, NL);
        i64 prev = 0;
        u64 bw[2 * NL - 2];
        for (int i = 0; i < 2 * NL - 1; i++) {
            int lo = i - NL + 1 > 0 ? i - NL + 1 : 0;
            int hi = i + 1 < NL ? i + 1 : NL;
            i64 conv = 0;
            for (int j = lo; j < hi; j++)
                conv += m29[j] * (i64)q9[i - j] - (i64)x9[j] * (i64)inv9[i - j];
            if (i < NL) conv += (i64)r9[i];
            i64 t = conv + prev;
            if (i < 2 * NL - 2) {
                if (t & MASK29) return 1;
                prev = t >> BITS;
                bw[i] = (u64)(prev + CARRY_OFFSET);
            } else if (t != 0) {
                return 3;
            }
        }
        store_limbs(vals, B, inv_t, NL, b, inv9);
        store_limbs(vals, B, q_t, NL, b, q9);
        for (int i = 0; i < 2 * NL - 2; i++) vals[b_t[i] * B + b] = bw[i];
    }
    return 0;
}

// s = (x + y) mod m (single fold); writes s (9), ovf (1), carries c (8, +1).
int op_add_nn(u64 *vals, i64 B, const i64 *x_t, i64 nx, const i64 *y_t, i64 ny,
              const i64 *s_t, i64 ovf_t, const i64 *c_t,
              const i64 *m_dig, i64 nmd, const i64 *m29) {
    Big m;
    big_zero(m);
    for (int i = 0; i < nmd; i++) m.d[i] = (u32)m_dig[i];
    m.n = (int)nmd;
    big_norm(m);
    for (i64 b = 0; b < B; b++) {
        u32 x9[NL], y9[NL], s9[NL];
        load_limbs(vals, B, x_t, (int)nx, b, x9, NL);
        load_limbs(vals, B, y_t, (int)ny, b, y9, NL);
        Big X, Y, S;
        from29(x9, NL, X);
        from29(y9, NL, Y);
        big_add(X, Y, S);
        int ge = big_cmp(S, m) >= 0;
        if (ge) big_sub_inplace(S, m);
        to29(S, s9, NL);
        i64 prev = 0;
        u64 c[NL - 1];
        for (int i = 0; i < NL; i++) {
            i64 t = (i64)x9[i] + (i64)y9[i] - (i64)ge * m29[i] - (i64)s9[i] + prev;
            if (i < NL - 1) {
                if (t & MASK29) return 1;
                prev = t >> BITS;
                c[i] = (u64)(prev + 1);
            } else if (t != 0) {
                return 3;
            }
        }
        store_limbs(vals, B, s_t, NL, b, s9);
        vals[ovf_t * B + b] = (u64)ge;
        for (int i = 0; i < NL - 1; i++) vals[c_t[i] * B + b] = c[i];
    }
    return 0;
}

// d = (x - y) mod m; writes d (9), ovf, carries c (8, +1).
int op_sub_nn(u64 *vals, i64 B, const i64 *x_t, i64 nx, const i64 *y_t, i64 ny,
              const i64 *d_t, i64 ovf_t, const i64 *c_t,
              const i64 *m_dig, i64 nmd, const i64 *m29) {
    Big m;
    big_zero(m);
    for (int i = 0; i < nmd; i++) m.d[i] = (u32)m_dig[i];
    m.n = (int)nmd;
    big_norm(m);
    for (i64 b = 0; b < B; b++) {
        u32 x9[NL], y9[NL], d9[NL];
        load_limbs(vals, B, x_t, (int)nx, b, x9, NL);
        load_limbs(vals, B, y_t, (int)ny, b, y9, NL);
        Big X, Y;
        from29(x9, NL, X);
        from29(y9, NL, Y);
        int brw = big_cmp(X, Y) < 0;
        if (brw) {
            Big t;
            big_add(X, m, t);
            X = t;
        }
        big_sub_inplace(X, Y);
        to29(X, d9, NL);
        i64 prev = 0;
        u64 c[NL - 1];
        for (int i = 0; i < NL; i++) {
            i64 t = (i64)x9[i] - (i64)y9[i] + (i64)brw * m29[i] - (i64)d9[i] + prev;
            if (i < NL - 1) {
                if (t & MASK29) return 1;
                prev = t >> BITS;
                c[i] = (u64)(prev + 1);
            } else if (t != 0) {
                return 3;
            }
        }
        store_limbs(vals, B, d_t, NL, b, d9);
        vals[ovf_t * B + b] = (u64)brw;
        for (int i = 0; i < NL - 1; i++) vals[c_t[i] * B + b] = c[i];
    }
    return 0;
}

// s = sum of k values mod m; writes s (9), ovf (quotient), carries (8, +2^33).
int op_add_many_nn(u64 *vals, i64 B, const i64 *terms, i64 k, i64 nt_per,
                   const i64 *s_t, i64 ovf_t, const i64 *c_t,
                   const i64 *m_dig, i64 nmd, const i64 *m29) {
    Big m;
    big_zero(m);
    for (int i = 0; i < nmd; i++) m.d[i] = (u32)m_dig[i];
    m.n = (int)nmd;
    big_norm(m);
    for (i64 b = 0; b < B; b++) {
        u32 t9[8][NL];
        Big tot, q, r;
        big_zero(tot);
        for (int t = 0; t < k; t++) {
            load_limbs(vals, B, terms + t * nt_per, (int)nt_per, b, t9[t], NL);
            Big V, S2;
            from29(t9[t], NL, V);
            big_add(tot, V, S2);
            tot = S2;
        }
        big_divmod(tot, m, q, r);
        u64 ov = q.n ? ((u64)q.d[0] | (q.n > 1 ? ((u64)q.d[1] << 32) : 0)) : 0;
        u32 s9[NL];
        to29(r, s9, NL);
        i64 prev = 0;
        u64 c[NL - 1];
        for (int i = 0; i < NL; i++) {
            i64 sum = 0;
            for (int t = 0; t < k; t++) sum += (i64)t9[t][i];
            i64 tt = sum - (i64)ov * m29[i] - (i64)s9[i] + prev;
            if (i < NL - 1) {
                if (tt & MASK29) return 1;
                prev = tt >> BITS;
                c[i] = (u64)(prev + CARRY_OFFSET);
            } else if (tt != 0) {
                return 3;
            }
        }
        store_limbs(vals, B, s_t, NL, b, s9);
        vals[ovf_t * B + b] = ov;
        for (int i = 0; i < NL - 1; i++) vals[c_t[i] * B + b] = c[i];
    }
    return 0;
}

// borrow-chain comparison x <= mm1 (constant limbs): writes d (9), brw (9), le.
int op_cmp_const(u64 *vals, i64 B, const i64 *x_t, i64 nx, const i64 *mv,
                 const i64 *d_t, const i64 *brw_t, i64 le_t) {
    for (i64 b = 0; b < B; b++) {
        u32 x9[NL];
        load_limbs(vals, B, x_t, (int)nx, b, x9, NL);
        i64 prev = 0;
        for (int i = 0; i < NL; i++) {
            i64 t = mv[i] - (i64)x9[i] - prev;
            i64 bi = t < 0;
            vals[d_t[i] * B + b] = (u64)(t + (bi << BITS));
            vals[brw_t[i] * B + b] = (u64)bi;
            prev = bi;
        }
        vals[le_t * B + b] = (u64)(1 - prev);
    }
    return 0;
}

// pooled base-4 range decomposition: for each of V values, write nl limbs.
int op_range(u64 *vals, i64 B, const i64 *v_t, i64 V, const i64 *limb_t,
             i64 nl) {
    for (i64 b = 0; b < B; b++) {
        for (i64 v = 0; v < V; v++) {
            u64 x = vals[v_t[v] * B + b];
            for (i64 j = 0; j < nl; j++)
                vals[limb_t[v * nl + j] * B + b] = (x >> (2 * j)) & 3;
        }
    }
    return 0;
}

// pooled LogUp range decomposition: nl limbs of lb bits per value
int op_range_lookup(u64 *vals, i64 B, const i64 *v_t, i64 V,
                    const i64 *limb_t, i64 nl, i64 lb) {
    u64 mask = ((u64)1 << lb) - 1;
    for (i64 b = 0; b < B; b++) {
        for (i64 v = 0; v < V; v++) {
            u64 x = vals[v_t[v] * B + b];
            for (i64 j = 0; j < nl; j++)
                vals[limb_t[v * nl + j] * B + b] = (x >> (lb * j)) & mask;
        }
    }
    return 0;
}

// LogUp multiplicity column: for each lane, histogram every looked-up limb
// term over the canonical table values [0, 2^lb) and write the m wires.
// gmeta: per group [val_count, nlimbs, scale]; gvals: concatenated value
// target ids (group-major); m_t: n multiplicity targets (row order).
int op_lookup_mult(u64 *vals, i64 B, const i64 *gmeta, i64 ngroups,
                   const i64 *gvals, const i64 *m_t, i64 n, i64 lb,
                   i64 zero_terms) {
    u64 mask = ((u64)1 << lb) - 1;
    for (i64 b = 0; b < B; b++) {
        for (i64 r = 0; r < n; r++) vals[m_t[r] * B + b] = 0;
        const i64 *vp = gvals;
        for (i64 g = 0; g < ngroups; g++) {
            i64 K = gmeta[3 * g], nl = gmeta[3 * g + 1], scale = gmeta[3 * g + 2];
            for (i64 k = 0; k < K; k++) {
                u64 x = vals[vp[k] * B + b];
                u64 top = 0;
                // out-of-table terms are skipped, not errors: they produce an
                // unsatisfiable witness (no multiplicity can match them), and
                // the soundness tests rely on generation still completing
                for (i64 j = 0; j < nl; j++) {
                    top = (x >> (lb * j)) & mask;
                    if (top < (u64)n) vals[m_t[top] * B + b] += 1;
                }
                if (scale > 1) {
                    u64 sc = top * (u64)scale;
                    if (sc < (u64)n) vals[m_t[sc] * B + b] += 1;
                }
            }
            vp += K;
        }
        vals[m_t[0] * B + b] += (u64)zero_terms;
    }
    return 0;
}

// out = c0*m1*m2 + c1*ad (Goldilocks)
int op_arith(u64 *vals, i64 B, i64 m1_t, i64 m2_t, i64 ad_t, i64 out_t,
             i64 c0, i64 c1) {
    for (i64 b = 0; b < B; b++) {
        u64 m1 = vals[m1_t * B + b], m2 = vals[m2_t * B + b];
        u64 ad = vals[ad_t * B + b];
        vals[out_t * B + b] = gadd(gmul(gmul((u64)c0, m1), m2), gmul((u64)c1, ad));
    }
    return 0;
}

// out = items[idx]; bits of idx; optional halves (t0, t1) for the split gate
int op_random_access(u64 *vals, i64 B, i64 idx_t, const i64 *item_t, i64 ni,
                     i64 out_t, const i64 *bit_t, i64 nb, const i64 *half_t,
                     i64 nh) {
    for (i64 b = 0; b < B; b++) {
        u64 iv = vals[idx_t * B + b];
        if (iv >= (u64)ni) return 1;
        vals[out_t * B + b] = vals[item_t[iv] * B + b];
        for (i64 j = 0; j < nb; j++)
            vals[bit_t[j] * B + b] = (iv >> j) & 1;
        if (nh == 2) {
            u64 low = iv & (u64)(ni / 2 - 1);
            vals[half_t[0] * B + b] = vals[item_t[low] * B + b];
            vals[half_t[1] * B + b] = vals[item_t[ni / 2 + low] * B + b];
        }
    }
    return 0;
}

// little-endian binary split of a value into `nb` bit targets
int op_split(u64 *vals, i64 B, i64 x_t, const i64 *bit_t, i64 nb) {
    for (i64 b = 0; b < B; b++) {
        u64 x = vals[x_t * B + b];
        for (i64 j = 0; j < nb; j++)
            vals[bit_t[j] * B + b] = (x >> j) & 1;
    }
    return 0;
}

// scatter the value table into the prover's wire tensors, directly in the
// device layout: out_lo/out_hi are u32 [B, num_wires, n] (C-contiguous,
// zero-initialized).  Skips the 2+GB u64 [wires, n, B] intermediate + the
// transpose + split copies that dominated witness generation at large B.
int op_scatter_wires(const u64 *vals, i64 B, const i64 *pos_cols,
                     const i64 *pos_rows, const i64 *pos_tids, i64 npos,
                     i64 num_wires, i64 n, u32 *out_lo, u32 *out_hi) {
    for (i64 p = 0; p < npos; p++) {
        const u64 *src = vals + pos_tids[p] * B;
        i64 base = pos_cols[p] * n + pos_rows[p];
        for (i64 b = 0; b < B; b++) {
            u64 v = src[b];
            out_lo[b * num_wires * n + base] = (u32)v;
            out_hi[b * num_wires * n + base] = (u32)(v >> 32);
        }
    }
    return 0;
}

// is_equal hint: inv = (a-b)^-1 mod GOLD_P (0 if equal), eq = (a == b)
int op_is_equal(u64 *vals, i64 B, i64 d_t, i64 inv_t, i64 eq_t) {
    for (i64 b = 0; b < B; b++) {
        u64 d = vals[d_t * B + b];
        u64 inv = 0;
        if (d != 0) {
            // Fermat: d^(p-2) mod p (64 squarings; fine at this call count)
            u64 e = GOLD_P - 2, base = d % GOLD_P, r = 1;
            while (e) {
                if (e & 1) r = gmul(r, base);
                base = gmul(base, base);
                e >>= 1;
            }
            inv = r;
        }
        vals[inv_t * B + b] = inv;
        vals[eq_t * B + b] = d == 0;
    }
    return 0;
}

// ME, MI [12 x 12] and the round constants [30 x 12], row-major; returns 1
// (and sets nothing) if a matrix entry is not below 2^32 or a constant not
// below p
int poseidon_set_constants(const i64 *me, const i64 *mi, const i64 *rc) {
    for (int k = 0; k < P2_W * P2_W; k++)
        if ((u64)me[k] >> 32 || (u64)mi[k] >> 32) return 1;
    for (int k = 0; k < P2_TR * P2_W; k++)
        if ((u64)rc[k] >= GOLD_P) return 1;
    memcpy(P2_ME, me, sizeof(P2_ME));
    memcpy(P2_MI, mi, sizeof(P2_MI));
    memcpy(P2_RC, rc, sizeof(P2_RC));
    p2_constants_set = 1;
    return 0;
}

// one PoseidonGate row a lane: reads the 12 inputs, writes the 106 stored
// S-box inputs (rounds 1..3 full, the 22 partial rounds' element 0, rounds
// 26..29 full, in wire order) and the 12 outputs
int op_poseidon(u64 *vals, i64 B, const i64 *in_t, const i64 *stored_t,
                const i64 *out_t) {
    if (!p2_constants_set) return 1;
    for (i64 b = 0; b < B; b++) {
        u64 s[P2_W], cur[P2_W], u[P2_W];
        for (int i = 0; i < P2_W; i++) s[i] = vals[in_t[i] * B + b];
        p2_layer(P2_ME, s, cur);                       // the initial external layer
        int k = 0;
        for (int r = 0; r < P2_TR; r++) {
            for (int i = 0; i < P2_W; i++) u[i] = gred128((u128)cur[i] + P2_RC[r][i]);
            bool full = r < P2_HF || r >= P2_HF + P2_PR;
            if (r >= 1) {
                int stored = full ? P2_W : 1;
                for (int i = 0; i < stored; i++) vals[stored_t[k++] * B + b] = u[i];
            }
            if (full) {
                for (int i = 0; i < P2_W; i++) u[i] = p2_sbox(u[i]);
                p2_layer(P2_ME, u, cur);
            } else {
                u[0] = p2_sbox(u[0]);
                p2_layer(P2_MI, u, cur);
            }
        }
        if (k != P2_STORED) return 2;
        for (int i = 0; i < P2_W; i++) vals[out_t[i] * B + b] = cur[i];
    }
    return 0;
}

}  // extern "C"
