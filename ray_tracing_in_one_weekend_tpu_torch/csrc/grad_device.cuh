// The adjoint of one bounce, written by hand for the backward's reverse
// walk (grad_kernel.cu, grad_reverse_kernel).
//
// It is the vector-Jacobian product of `_bounce_f` in
// ops/cuda_grad.py (the JAX kernel's `F`), which the plain version gets
// from torch.autograd: the bounce as a function of the pre-bounce ray
// origin o, unit direction d, attenuation att and the winning sphere's
// parameters, with its discrete decisions frozen. The primal is recomputed
// here with the expressions of render_device.cuh in their order, so with
// the same build flags every decision (near or far root, front face,
// lambertian fallback, dielectric reflect or refract) is the forward's.
//
// Conventions at a kink follow torch's: a clamp passes the gradient at
// equality, and the where-guarded square roots pass none at 0.
#pragma once

#include "render_device.cuh"

namespace rt {

constexpr float GRAD_CLIP = 1e6f;

// The cotangent of a sphere's parameters that a bounce can make non-zero:
// 13 of the 16 rows (r^2, mat and active never reach the output).
struct PBar {
    vec3 c;       // center (rows 0-2)
    float r;      // signed radius (row 3)
    vec3 albedo;  // rows 5-7
    float fuzz;   // row 8
    float ior;    // row 9
    vec3 m2c;     // -2c (rows 12-14)
    float csq;    // |c|^2 - r^2 (row 15)
};

__device__ __forceinline__ float clipf(float x) { return fminf(fmaxf(x, -GRAD_CLIP), GRAD_CLIP); }
__device__ __forceinline__ vec3 clip3(vec3 v) { return {clipf(v.x), clipf(v.y), clipf(v.z)}; }
__device__ __forceinline__ void clip_pbar(PBar& p) {
    p.c = clip3(p.c);
    p.r = clipf(p.r);
    p.albedo = clip3(p.albedo);
    p.fuzz = clipf(p.fuzz);
    p.ior = clipf(p.ior);
    p.m2c = clip3(p.m2c);
    p.csq = clipf(p.csq);
}

// A miss: radiance att * sky(d). Given the radiance cotangent g, sets the
// adjoints of d and att (the path's last event; nothing flows in after it).
__device__ __forceinline__ void sky_adjoint(vec3 d, vec3 att, vec3 g, vec3& db, vec3& ab) {
    const float a = 0.5f * (d.y + 1.0f);
    const vec3 sky = {(1.0f - a) + a * 0.5f, (1.0f - a) + a * 0.7f, (1.0f - a) + a * 1.0f};
    ab = g * sky;
    const vec3 ga = g * att;
    const float a_bar = ga.x * (0.5f - 1.0f) + ga.y * (0.7f - 1.0f) + ga.z * (1.0f - 1.0f);
    db = {0.0f, 0.5f * a_bar, 0.0f};
}

// d_bar and n_bar of reflect(d, n) = d - 2 (d.n) n for the cotangent rb.
__device__ __forceinline__ void reflect_adjoint(vec3 d, vec3 n, vec3 rb, vec3& d_bar, vec3& n_bar) {
    const float dn = dot3(d, n);
    const float rb_n = dot3(rb, n);
    d_bar = d_bar + rb - (2.0f * rb_n) * n;
    n_bar = n_bar - (2.0f * dn) * rb - (2.0f * rb_n) * d;
}

// A bounce that continues off the sphere `row` (its table row): o' = p,
// d' = scatter direction, att' = att * material attenuation. On entry ob,
// db, ab are the cotangents of o', d', att'; on exit those of o, d, att,
// and pb holds the sphere's parameter cotangent.
__device__ __forceinline__ void bounce_adjoint(const float4* row, vec3 o, vec3 d, vec3 att, Stream st,
                                               uint32_t ctr, float t_min, vec3& ob, vec3& db, vec3& ab,
                                               PBar& pb) {
    // ---- primal, as closest_hit and bounce compute it ----
    const float4 c4 = row[0];  // cx, cy, cz, r
    const float4 r1 = row[1];  // r^2, albedo rgb
    const float4 r2 = row[2];  // fuzz, ior, mat, active
    const float4 m = row[3];   // -2cx, -2cy, -2cz, |c|^2 - r^2
    const vec3 c = {c4.x, c4.y, c4.z};
    const vec3 m2c = {m.x, m.y, m.z};
    const float o_dot_d = dot3(o, d);
    const float o_sq = dot3(o, o);
    const float d_dot_c = c.x * d.x + c.y * d.y + c.z * d.z;
    const float cc_part = m.w + m.x * o.x + m.y * o.y + m.z * o.z;
    const float half_b = o_dot_d - d_dot_c;
    const float cc = o_sq + cc_part;
    const float disc = half_b * half_b - cc;
    // The 1e-12 floor keeps the sqrt derivative finite on a grazing hit.
    const float sqrt_d = sqrtf(fmaxf(disc, 1e-12f));
    const float root_near = -half_b - sqrt_d;
    const bool near = root_near > t_min;
    const float t = near ? root_near : -half_b + sqrt_d;
    const vec3 p = o + t * d;
    const bool r_ok = fabsf(c4.w) > 1e-8f;
    const float inv_r = 1.0f / (r_ok ? c4.w : 1.0f);
    const vec3 pc = p - c;
    const vec3 outward = pc * inv_r;
    const bool front_face = dot3(d, outward) < 0.0f;
    const vec3 n = front_face ? outward : -outward;

    const float mat = r2.z;
    const bool is_lam = mat < 0.5f;
    const bool is_metal = mat >= 0.5f && mat < 1.5f;
    vec3 dir, u = {0.0f, 0.0f, 0.0f};
    // Dielectric intermediates.
    bool refract = false;
    float ratio = 1.0f, cos_in = 0.0f, cos_theta = 0.0f, k = 0.0f, sqrtk = 0.0f;
    vec3 r_perp = {0.0f, 0.0f, 0.0f}, w = {0.0f, 0.0f, 0.0f};
    if (is_lam || is_metal) {
        u = unit_vectors(st, ctr);
        if (is_lam) {
            dir = n + u;
            if (dot3(dir, dir) < 1e-16f) dir = n;
        } else {
            const vec3 reflected = d - (2.0f * dot3(d, n)) * n;
            dir = reflected + r2.x * u;
        }
    } else {
        const float reflect_u = u01(st, ctr + 4u);
        const float ior = r2.y;
        ratio = front_face ? 1.0f / ior : ior;
        cos_in = dot3(-d, n);
        cos_theta = fminf(cos_in, 1.0f);
        const float s2 = fmaxf(1.0f - cos_theta * cos_theta, 0.0f);
        const float sin_theta = s2 > 0.0f ? sqrtf(s2) : 0.0f;
        const bool cannot_refract = ratio * sin_theta > 1.0f;
        float r0 = (1.0f - ratio) / (1.0f + ratio);
        r0 = r0 * r0;
        const float one_m_cos = 1.0f - cos_theta;
        const float omc2 = one_m_cos * one_m_cos;
        const float schlick = r0 + (1.0f - r0) * (one_m_cos * (omc2 * omc2));
        if (cannot_refract || schlick > reflect_u) {
            dir = d - (2.0f * dot3(d, n)) * n;
        } else {
            refract = true;
            w = d + cos_theta * n;
            r_perp = ratio * w;
            k = fmaxf(1.0f - dot3(r_perp, r_perp), 0.0f);
            sqrtk = k > 0.0f ? sqrtf(k) : 0.0f;
            dir = r_perp + (-sqrtk) * n;
        }
    }

    // ---- adjoint ----
    pb = PBar{};
    // att' = att * mat_atten (1 for a dielectric).
    if (is_lam || is_metal) {
        pb.albedo = ab * att;
        ab = ab * vec3{r1.y, r1.z, r1.w};
    }
    // d' = normalize3(dir) = dir * rsqrt(max(|dir|^2, 1e-20)).
    const float s = dot3(dir, dir);
    const float rs = rsqrtf(fmaxf(s, 1e-20f));
    const float s_bar = s >= 1e-20f ? dot3(db, dir) * (-0.5f * rs * rs * rs) : 0.0f;
    const vec3 dir_bar = db * rs + (2.0f * s_bar) * dir;

    vec3 d_bar = {0.0f, 0.0f, 0.0f}, n_bar = {0.0f, 0.0f, 0.0f};
    if (is_lam) {
        n_bar = dir_bar;  // dir = n + u, or n on the degenerate fallback
    } else if (is_metal) {
        pb.fuzz = dot3(dir_bar, u);
        reflect_adjoint(d, n, dir_bar, d_bar, n_bar);
    } else if (!refract) {
        reflect_adjoint(d, n, dir_bar, d_bar, n_bar);
    } else {
        // dir = r_perp - sqrtk n, r_perp = ratio (d + cos_theta n),
        // sqrtk = sqrt(max(1 - |r_perp|^2, 0)) where k > 0, else 0.
        vec3 rp_bar = dir_bar;
        n_bar = n_bar - sqrtk * dir_bar;
        if (k > 0.0f) {
            const float k_bar = -dot3(dir_bar, n) * (0.5f / sqrtk);
            rp_bar = rp_bar - (2.0f * k_bar) * r_perp;
        }
        const float ratio_bar = dot3(rp_bar, w);
        const vec3 w_bar = ratio * rp_bar;
        d_bar = d_bar + w_bar;
        n_bar = n_bar + cos_theta * w_bar;
        if (cos_in <= 1.0f) {
            const float cos_bar = dot3(w_bar, n);
            d_bar = d_bar - cos_bar * n;
            n_bar = n_bar - cos_bar * d;
        }
        pb.ior = front_face ? -ratio_bar * (ratio * ratio) : ratio_bar;
    }

    // n = +-(p - c) / r.
    const vec3 out_bar = front_face ? n_bar : -n_bar;
    const vec3 p_bar = ob + out_bar * inv_r;
    pb.c = -(out_bar * inv_r);
    pb.r = r_ok ? -dot3(out_bar, pc) * (inv_r * inv_r) : 0.0f;
    // p = o + t d.
    const float t_bar = dot3(p_bar, d);
    d_bar = d_bar + t * p_bar;
    // t = -half_b -+ sqrt(max(disc, 1e-12)).
    float half_b_bar = -t_bar;
    const float sqrt_d_bar = near ? -t_bar : t_bar;
    const float disc_bar = disc >= 1e-12f ? sqrt_d_bar * (0.5f / sqrt_d) : 0.0f;
    half_b_bar += 2.0f * half_b * disc_bar;
    const float cc_bar = -disc_bar;
    // half_b = o.d - c.d, cc = o.o + (|c|^2 - r^2) + (-2c).o.
    ob = p_bar + half_b_bar * d + (2.0f * cc_bar) * o + cc_bar * m2c;
    db = d_bar + half_b_bar * o - half_b_bar * c;
    pb.c = pb.c - half_b_bar * d;
    pb.m2c = cc_bar * o;
    pb.csq = cc_bar;
}

}  // namespace rt
