"""Scripted task solutions for demo generation, on the port's batched envs.

Port of ``maniskill_tpu/examples/motionplanning/solutions.py``: closed-loop
Cartesian servo policies under ``pd_ee_delta_pos`` (``pd_ee_delta_pose``
where ``CONTROL_MODES`` says) that solve tasks from state, every env of the
batch at once. The policies are numpy on the host; each control step reads
the state they need from the device once (``_host``: the TCP pose and the
free, kinematic and joint state in one copy), and the env runs the step on
the device (the CUDA mega-kernel, with the IK step's solve kernel, on a
card). Ported: the solutions of PickCube, PushCube, PullCube, StackCube,
RollBall, PickSingleHull, LiftPegUpright, PegInsertionSide, PlugCharger,
PullCubeTool and FoldSuitcase. DrawTriangle/DrawSVG (``panda_stick``) and
PickCubeYCB wait for their tasks.

``recorder``: an object with the env's ``step`` (a trajectory recorder
wrapping the env); ``None`` steps the env itself.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ...envs.base_env import TaskContext


def _host(env) -> dict:
    """The current state's numbers the solutions read, as numpy arrays:
    ``tcp_p`` (B, 3), ``tcp_q`` (B, 4), ``free_pose`` (B, F, 7),
    ``free_vel`` (B, F, 6), ``kin_pose`` (B, N, 7), ``qpos`` (B, nq). One
    device-to-host copy per state, cached until the env's state changes."""
    s = env._state
    cached = env.__dict__.get("_solution_host")
    if cached is not None and cached[0] is s:
        return cached[1]
    tcp = TaskContext(env, s).tcp_pose
    parts = dict(tcp_p=tcp.p, tcp_q=tcp.q, free_pose=s.sim.free_pose,
                 free_vel=s.sim.free_vel, kin_pose=s.sim.kin_pose, qpos=s.sim.qpos)
    B = s.sim.qpos.shape[0]
    flat = torch.cat([t.reshape(B, -1).to(torch.float32) for t in parts.values()], -1)
    flat = flat.cpu().numpy()
    out, off = {}, 0
    for name, t in parts.items():
        n = t[0].numel()
        out[name] = flat[:, off:off + n].reshape((B,) + tuple(t.shape[1:]))
        off += n
    env._solution_host = (s, out)
    return out


def _tcp_and_actor(env, actor: str) -> Tuple[np.ndarray, np.ndarray]:
    h = _host(env)
    return h["tcp_p"], h["free_pose"][:, env.model.free_index[actor], :3]


def _tcp_pose(env) -> Tuple[np.ndarray, np.ndarray]:
    """Batched TCP position (B, 3) and quaternion (B, 4)."""
    h = _host(env)
    return h["tcp_p"], h["tcp_q"]


def _actor_pose(env, actor: str) -> Tuple[np.ndarray, np.ndarray]:
    raw = _host(env)["free_pose"][:, env.model.free_index[actor]]
    return raw[:, :3], raw[:, 3:7]


def _actor_vel(env, actor: str) -> np.ndarray:
    """Linear velocity (B, 3) of a free body."""
    return _host(env)["free_vel"][:, env.model.free_index[actor], :3]


def _kin_position(env, name: str) -> np.ndarray:
    """Position (B, 3) of a kinematic body (a goal site, a goal region)."""
    return _host(env)["kin_pose"][:, env.model.kin_index[name], :3]


def _quat_apply_np(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Batched quaternion rotation (B, 4) x (B, 3) -> (B, 3)."""
    w = q[:, 0:1]
    uv = 2.0 * np.cross(q[:, 1:], v)
    return v + w * uv + np.cross(q[:, 1:], uv)


def _yaw_of(q: np.ndarray) -> np.ndarray:
    """Yaw of the body x-axis projected on the table plane, (B,)."""
    x_axis = _quat_apply_np(q, np.tile(np.array([1.0, 0, 0]), (len(q), 1)))
    return np.arctan2(x_axis[:, 1], x_axis[:, 0])


class _PoseServo:
    """Closed-loop EE servo shared by the pose-controlled solutions.

    ``mode='pos'`` drives ``pd_ee_delta_pos`` (action [dxyz, grip]);
    ``mode='pose'`` drives ``pd_ee_delta_pose`` (action [dxyz,
    axis-angle-drot (root frame), grip], agents/controllers/ee.py:82-95).
    """

    def __init__(self, env, recorder=None):
        self.env = env
        self.stepper = recorder if recorder is not None else env
        self.B = env.num_envs
        self.with_rot = env.control_mode == "pd_ee_delta_pose"
        self.adim = env.action_dim
        self.last = None

    def act(self, dpos, drot=None, grip=1.0):
        a = np.zeros((self.B, self.adim), np.float32)
        a[:, :3] = dpos
        if self.with_rot:
            if drot is not None:
                a[:, 3:6] = drot
            a[:, 6] = grip
        elif self.adim > 3:  # stick robots (no gripper) are 3-dof
            a[:, 3] = grip
        self.last = self.stepper.step(a)
        return self.last

    def to(self, target_fn, steps, gain=3.0, grip=1.0, clip=0.7,
           rot_fn=None, rot_gain=3.0, rot_clip=0.6):
        """Servo the TCP to ``target_fn() -> (B, 3)`` positions; with
        ``rot_fn() -> (B, 3)`` world-frame rotation errors (axis*angle),
        also align orientation."""
        for _ in range(steps):
            tcp, tq = _tcp_pose(self.env)
            dpos = np.clip((target_fn() - tcp) * gain, -clip, clip)
            drot = None
            if rot_fn is not None and self.with_rot:
                drot = np.clip(rot_fn() * rot_gain, -rot_clip, rot_clip)
            self.act(dpos, drot, grip)
        return self.last

    def hold(self, steps, grip):
        for _ in range(steps):
            self.act(np.zeros((self.B, 3), np.float32), None, grip)
        return self.last

    def success(self):
        return _success(self.last)


def _axis_angle_between(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """World-frame rotation (axis*angle, (B, 3)) taking direction u to v."""
    u = u / np.linalg.norm(u, axis=1, keepdims=True).clip(1e-9)
    v = v / np.linalg.norm(v, axis=1, keepdims=True).clip(1e-9)
    axis = np.cross(u, v)
    s = np.linalg.norm(axis, axis=1, keepdims=True)
    c = np.sum(u * v, axis=1, keepdims=True)
    ang = np.arctan2(s, c)
    safe = axis / s.clip(1e-9)
    return np.where(s > 1e-6, safe * ang, np.zeros_like(axis))


def _success(out) -> np.ndarray:
    """The (B,) success mask of a step's ``(obs, reward, terminated,
    truncated, info)``."""
    return out[-1]["success"].cpu().numpy()


def solve_pick_cube(env, recorder=None, lift_height: float = 0.25):
    """Closed-loop pick-and-lift for PickCube-v1 (pd_ee_delta_pos):
    hover → descend → close → move to goal. Returns final success mask."""
    assert env.control_mode == "pd_ee_delta_pos"
    stepper = recorder if recorder is not None else env
    B = env.num_envs

    def act(dxyz, grip):
        a = np.zeros((B, env.action_dim), np.float32)
        a[:, :3] = dxyz
        a[:, 3] = grip
        return stepper.step(a)

    def servo(target_fn, steps, gain=3.0, grip=1.0):
        out = None
        for _ in range(steps):
            tcp, cube = _tcp_and_actor(env, "cube")
            tgt = target_fn(tcp, cube)
            out = act(np.clip((tgt - tcp) * gain, -0.4, 0.4), grip)
        return out

    # 1) hover above the cube
    servo(lambda tcp, cube: np.concatenate(
        [cube[:, :2], np.full((B, 1), 0.10)], axis=1), steps=30)
    # 2) descend to grasp height (closed loop compensates tracking error)
    servo(lambda tcp, cube: np.concatenate(
        [cube[:, :2], np.full((B, 1), 0.05)], axis=1), steps=25)
    servo(lambda tcp, cube: np.concatenate(
        [cube[:, :2], np.full((B, 1), 0.022)], axis=1), steps=25, gain=2.0)
    # 3) close the gripper
    out = None
    for _ in range(8):
        out = act(np.zeros((B, 3), np.float32), grip=-1.0)
    # 4) carry to the goal site (track the cube onto the goal, then settle)
    goal = _kin_position(env, "goal_site")
    for _ in range(60):
        tcp, cube = _tcp_and_actor(env, "cube")
        out = act(np.clip((goal - cube) * 3.0, -0.4, 0.4), grip=-1.0)
    # settle: hold position so the arm becomes static (success requires
    # qvel < 0.2, reference pick_cube.py:119)
    for _ in range(6):
        out = act(np.zeros((B, 3), np.float32), grip=-1.0)
    return _success(out)


def solve_push_cube(env, recorder=None):
    """Closed-loop push for PushCube-v1: get behind the cube, push forward."""
    assert env.control_mode == "pd_ee_delta_pos"
    stepper = recorder if recorder is not None else env
    B = env.num_envs

    def act(dxyz, grip=-1.0):
        a = np.zeros((B, env.action_dim), np.float32)
        a[:, :3] = dxyz
        a[:, 3] = grip
        return stepper.step(a)

    out = None
    # behind and above the cube
    for _ in range(14):
        tcp, cube = _tcp_and_actor(env, "cube")
        tgt = cube + np.array([-0.06, 0.0, 0.06])
        out = act(np.clip((tgt - tcp) * 3.0, -0.4, 0.4))
    # drop behind it
    for _ in range(8):
        tcp, cube = _tcp_and_actor(env, "cube")
        tgt = np.concatenate([cube[:, :2] + [-0.055, 0.0], np.full((B, 1), 0.02)], 1)
        out = act(np.clip((tgt - tcp) * 3.0, -0.4, 0.4))
    # push toward the goal
    goal = _kin_position(env, "goal_region")
    for _ in range(22):
        tcp, cube = _tcp_and_actor(env, "cube")
        direction = goal[:, :2] - cube[:, :2]
        n = np.linalg.norm(direction, axis=1, keepdims=True).clip(1e-6)
        tgt_xy = cube[:, :2] - direction / n * 0.045
        tgt = np.concatenate([tgt_xy + direction * 0.6, np.full((B, 1), 0.02)], 1)
        out = act(np.clip((tgt - tcp) * 3.0, -0.3, 0.3))
    return _success(out)


def solve_pull_cube(env, recorder=None):
    """Closed-loop pull for PullCube-v1: hook the far side of the cube and
    drag it back to the goal region (reference solutions/pull_cube.py)."""
    assert env.control_mode == "pd_ee_delta_pos"
    stepper = recorder if recorder is not None else env
    B = env.num_envs

    def act(dxyz, grip=-1.0):
        a = np.zeros((B, env.action_dim), np.float32)
        a[:, :3] = dxyz
        a[:, 3] = grip
        return stepper.step(a)

    out = None
    goal = _kin_position(env, "goal_region")
    # above the far side (away from the goal)
    for _ in range(30):
        tcp, cube = _tcp_and_actor(env, "cube")
        d = cube[:, :2] - goal[:, :2]
        n = np.linalg.norm(d, axis=1, keepdims=True).clip(1e-6)
        tgt = np.concatenate([cube[:, :2] + d / n * 0.06,
                              np.full((B, 1), 0.08)], 1)
        out = act(np.clip((tgt - tcp) * 3.0, -0.4, 0.4))
    # drop to table height beyond the cube
    for _ in range(14):
        tcp, cube = _tcp_and_actor(env, "cube")
        d = cube[:, :2] - goal[:, :2]
        n = np.linalg.norm(d, axis=1, keepdims=True).clip(1e-6)
        tgt = np.concatenate([cube[:, :2] + d / n * 0.05,
                              np.full((B, 1), 0.02)], 1)
        out = act(np.clip((tgt - tcp) * 3.0, -0.4, 0.4))
    # drag toward the goal
    for _ in range(40):
        tcp, cube = _tcp_and_actor(env, "cube")
        d = goal[:, :2] - cube[:, :2]
        tgt = np.concatenate([cube[:, :2] + d * 0.8,
                              np.full((B, 1), 0.02)], 1)
        out = act(np.clip((tgt - tcp) * 2.5, -0.3, 0.3))
    return _success(out)


def solve_stack_cube(env, recorder=None):
    """Pick cube A, place it on cube B, release and retreat (reference
    solutions/stack_cube.py)."""
    assert env.control_mode == "pd_ee_delta_pos"
    stepper = recorder if recorder is not None else env
    B = env.num_envs

    def act(dxyz, grip):
        a = np.zeros((B, env.action_dim), np.float32)
        a[:, :3] = dxyz
        a[:, 3] = grip
        return stepper.step(a)

    def servo_xyz(name, xy_of, z, steps, gain=3.0, grip=1.0, clip=0.4):
        out = None
        for _ in range(steps):
            tcp, obj = _tcp_and_actor(env, name)
            tgt = np.concatenate([xy_of(obj), np.full((B, 1), z)], 1)
            out = act(np.clip((tgt - tcp) * gain, -clip, clip), grip)
        return out

    # hover over cube A, descend, grasp (solve_pick_cube schedule)
    servo_xyz("cubeA", lambda o: o[:, :2], 0.10, 30)
    servo_xyz("cubeA", lambda o: o[:, :2], 0.05, 25)
    servo_xyz("cubeA", lambda o: o[:, :2], 0.022, 25, gain=2.0)
    out = None
    for _ in range(8):
        out = act(np.zeros((B, 3), np.float32), grip=-1.0)
    # lift straight up, traverse above cube B, lower to stack height
    servo_xyz("cubeB", lambda o: o[:, :2], 0.12, 35, grip=-1.0)
    servo_xyz("cubeB", lambda o: o[:, :2], 0.085, 20, gain=2.0, grip=-1.0)
    # release + retreat
    for _ in range(6):
        out = act(np.zeros((B, 3), np.float32), grip=1.0)
    for _ in range(12):
        out = act(np.tile(np.array([0, 0, 0.3], np.float32), (B, 1)),
                  grip=1.0)
    return _success(out)


def solve_roll_ball(env, recorder=None):
    """Push the ball toward the goal region (reference
    solutions/roll_ball-style hit servo)."""
    assert env.control_mode == "pd_ee_delta_pos"
    stepper = recorder if recorder is not None else env
    B = env.num_envs

    def act(dxyz, grip=-1.0):
        a = np.zeros((B, env.action_dim), np.float32)
        a[:, :3] = dxyz
        a[:, 3] = grip
        return stepper.step(a)

    out = None
    goal = _kin_position(env, "goal_region")
    # The engine has no rolling resistance: a struck sphere never stops on
    # its own, and pushing a sphere with the closed fist is laterally
    # unstable (any contact offset grows — debug traces showed 45-degree
    # deflections and balls rolling off the table). So: DRIBBLE — keep the
    # fist just behind the ball and advance slowly, re-steering every step
    # (quasi-static push; lateral error cannot grow faster than the
    # re-steer) — then near the goal hop OVER the ball, drop in front, and
    # let it roll into the parked fist, which pins it in the region.
    for t in range(260):
        tcp, ball = _tcp_and_actor(env, "ball")
        bv = _actor_vel(env, "ball")
        d = goal[:, :2] - ball[:, :2]
        dist = np.linalg.norm(d, axis=1, keepdims=True)
        dhat = d / dist.clip(1e-6)
        speed = np.linalg.norm(bv[:, :2], axis=1, keepdims=True)
        done = (dist < 0.08) & (speed < 0.05)
        capture = dist < 0.11
        # capture: park in front along the travel/goal line
        front = np.concatenate(
            [ball[:, :2] + dhat * 0.055, np.full((B, 1), 0.045)], 1)
        f_far = np.linalg.norm(
            (front - tcp)[:, :2], axis=1, keepdims=True) > 0.045
        cap_tgt = np.where(f_far, front + np.array([0, 0, 0.10]), front)
        # dribble: fist face at the ball's back equator (ball r 0.035 +
        # fist half-width ~0.013), carrot 3 cm ahead so the push never
        # reaches servo equilibrium (a ball-relative target stalls: the
        # tcp converges onto it and the contact force balances out)
        behind = np.concatenate(
            [ball[:, :2] - dhat * 0.048, np.full((B, 1), 0.040)], 1)
        b_far = np.linalg.norm(
            (behind - tcp)[:, :2], axis=1, keepdims=True) > 0.055
        carrot = behind + np.concatenate(
            [dhat * 0.03, np.zeros((B, 1))], 1)
        drib_tgt = np.where(b_far, behind + np.array([0, 0, 0.11]), carrot)
        gain = np.where(capture, 3.0, 2.0)
        clip = np.where(capture | b_far, 0.45, 0.12)
        err = np.where(capture, (cap_tgt - tcp) * gain,
                       (drib_tgt - tcp) * gain)
        err = np.where(done, 0.0, err)
        out = act(np.clip(err, -clip, clip))
    return _success(out)


def solve_pick_object(env, recorder=None, actor: str = "cube",
                      goal: str = "goal_site"):
    """Generic pick-and-place for the PickSingleHull / PickCubeYCB family
    (reference solutions/pick_cube_ycb.py): like solve_pick_cube but the
    descend height tracks the object's actual center (per-env hull heights
    differ)."""
    assert env.control_mode == "pd_ee_delta_pos"
    sv = _PoseServo(env, recorder)
    B = env.num_envs

    def obj():
        return _tcp_and_actor(env, actor)[1]

    sv.to(lambda: np.concatenate(
        [obj()[:, :2], np.full((B, 1), 0.12)], 1), steps=30)
    sv.to(lambda: np.concatenate(
        [obj()[:, :2], obj()[:, 2:3] + 0.02], 1), steps=25)
    sv.to(lambda: np.concatenate(
        [obj()[:, :2], obj()[:, 2:3]], 1), steps=20, gain=2.0)
    sv.hold(8, grip=-1.0)
    goal_p = _kin_position(env, goal)
    for _ in range(60):
        tcp, o = _tcp_and_actor(env, actor)
        sv.act(np.clip((goal_p - o) * 3.0, -0.4, 0.4), grip=-1.0)
    sv.hold(6, grip=-1.0)
    return sv.success()


def _tcp_x_across(env, dir_fn):
    """rot_fn: yaw error (mod pi) aligning the TCP x-axis with the world
    direction ``dir_fn() -> (B, 3)`` — puts the finger-opening axis (tcp y)
    ACROSS the object so the grasp wraps it."""
    B = env.num_envs

    def rot_fn():
        _, tq = _tcp_pose(env)
        tx = _quat_apply_np(tq, np.tile(np.array([1.0, 0, 0]), (B, 1)))
        d = dir_fn()
        a = np.arctan2(d[:, 1], d[:, 0])
        b = np.arctan2(tx[:, 1], tx[:, 0])
        e = (a - b + np.pi / 2) % np.pi - np.pi / 2
        out = np.zeros((B, 3), np.float32)
        out[:, 2] = e
        return out

    return rot_fn


def solve_lift_peg_upright(env, recorder=None):
    """LiftPegUpright-v1 under ``pd_ee_delta_pose`` (reference
    solutions/lift_peg_upright.py): grasp the lying peg at its center,
    lift, rotate the long axis to vertical, lower until the base touches
    the table."""
    assert env.control_mode == "pd_ee_delta_pose"
    sv = _PoseServo(env, recorder)
    B = env.num_envs
    L = env.peg_half_length

    def peg():
        return _actor_pose(env, "peg")

    def peg_dir():
        p, q = peg()
        return _quat_apply_np(q, np.tile(np.array([1.0, 0, 0]), (B, 1)))

    yaw_across = _tcp_x_across(env, peg_dir)
    # grasp the peg center from above with the fingers across the peg
    sv.to(lambda: np.concatenate(
        [peg()[0][:, :2], np.full((B, 1), 0.10)], 1), steps=32,
        rot_fn=yaw_across)
    sv.to(lambda: np.concatenate(
        [peg()[0][:, :2], np.full((B, 1), 0.024)], 1), steps=30, gain=2.5,
        clip=0.35, rot_fn=yaw_across)
    sv.hold(8, grip=-1.0)

    # lift well clear of the table, then rotate the peg x-axis onto +z
    up = np.tile(np.array([0.0, 0.0, 1.0]), (B, 1))

    def rot_err():
        d = peg_dir()
        # rotate the end currently pointing higher toward +z
        sgn = np.where(d[:, 2:3] >= 0.0, 1.0, -1.0)
        return _axis_angle_between(d * sgn, up)

    sv.to(lambda: np.concatenate(
        [peg()[0][:, :2], np.full((B, 1), 0.30)], 1),
        steps=28, grip=-1.0)
    sv.to(lambda: np.concatenate(
        [peg()[0][:, :2], np.full((B, 1), 0.30)], 1),
        steps=70, grip=-1.0, rot_fn=rot_err, rot_clip=0.8)
    # some spawns stall the pitch mid-way on a wrist limit (observed:
    # dir_z plateaus ~0.45); give those envs a yaw nudge to re-configure
    # the wrist, then finish the rotation
    def rot_err_with_escape():
        e = rot_err()
        d = peg_dir()
        stalled = (np.abs(d[:, 2:3]) < 0.8).astype(np.float32)
        e[:, 2] += 0.5 * stalled[:, 0]
        return e

    sv.to(lambda: np.concatenate(
        [peg()[0][:, :2], np.full((B, 1), 0.30)], 1),
        steps=30, grip=-1.0, rot_fn=rot_err_with_escape, rot_clip=0.8)
    sv.to(lambda: np.concatenate(
        [peg()[0][:, :2], np.full((B, 1), 0.30)], 1),
        steps=40, grip=-1.0, rot_fn=rot_err, rot_clip=0.8)
    # lower until the peg base is just above the table, release, retreat:
    # a near-upright 2L peg standing on its end is statically stable
    # (CoM-over-base margin atan(w/L) ≈ 0.2 rad >> the residual tilt), so
    # gravity settles it to EXACTLY upright once released
    sv.to(lambda: np.concatenate(
        [peg()[0][:, :2], np.full((B, 1), L + 0.01)],
        1), steps=45, gain=2.0, clip=0.3, grip=-1.0, rot_fn=rot_err,
        rot_clip=0.8)
    sv.hold(4, grip=1.0)  # release
    for _ in range(10):  # retreat straight up, peg settles
        sv.act(np.tile(np.array([0, 0, 0.5], np.float32), (B, 1)),
               grip=1.0)
    sv.hold(8, grip=1.0)
    return sv.success()


def solve_peg_insertion_side(env, recorder=None):
    """PegInsertionSide-v1 under ``pd_ee_delta_pose`` (reference
    solutions/peg_insertion_side.py): yaw-align, grasp the peg, align its
    axis with the hole, pre-position the head at the entrance, push in."""
    assert env.control_mode == "pd_ee_delta_pose"
    sv = _PoseServo(env, recorder)
    B = env.num_envs
    half = env._state.extras["peg_half_size"].cpu().numpy()  # (B, 3)
    Ls = half[:, 0:1]

    box_raw = _host(env)["kin_pose"][:, env.model.kin_index["box_with_hole"]]
    box_p, box_q = box_raw[:, :3], box_raw[:, 3:7]
    box_x = _quat_apply_np(box_q, np.tile(np.array([1.0, 0, 0]), (B, 1)))

    def peg():
        return _actor_pose(env, "peg")

    def peg_x():
        return _quat_apply_np(peg()[1],
                              np.tile(np.array([1.0, 0, 0]), (B, 1)))

    def head():
        p, _ = peg()
        return p + peg_x() * Ls

    # close the fingers ACROSS the peg: align the tcp x-axis with the
    # peg long axis (mod pi) about world z
    tcp_yaw_err = _tcp_x_across(env, peg_x)

    # hover above the peg center with the wrist yawed across the peg
    sv.to(lambda: np.concatenate(
        [peg()[0][:, :2], np.full((B, 1), 0.10)], 1),
        steps=32, rot_fn=tcp_yaw_err)
    sv.to(lambda: np.concatenate(
        [peg()[0][:, :2], half[:, 1:2] * 0.8], 1),
        steps=30, gain=2.5, clip=0.35, rot_fn=tcp_yaw_err)
    sv.hold(8, grip=-1.0)

    # lift and align the peg axis (head first) with the hole axis
    def axis_err():
        # rotate so the peg head points along the box +x (insertion dir)
        return _axis_angle_between(peg_x(), box_x)

    hole_entry = box_p - box_x * (Ls + 0.04)
    sv.to(lambda: peg()[0] * np.array([1, 1, 0]) + np.array([0, 0, 0.20]),
          steps=25, grip=-1.0)
    # drive the HEAD to the entrance, then through, while holding
    # alignment: the tcp moves by the head error (rigid transform)
    for phase_steps, tgt_off in ((45, hole_entry), (50, box_p)):
        for _ in range(phase_steps):
            err = tgt_off - head()
            drot = np.clip(axis_err() * 2.0, -0.3, 0.3)
            sv.act(np.clip(err * 2.0, -0.25, 0.25), drot, grip=-1.0)
    sv.hold(4, grip=-1.0)
    return sv.success()


def solve_plug_charger(env, recorder=None):
    """PlugCharger-v1 under ``pd_ee_delta_pose`` (reference
    solutions/plug_charger.py): grasp the charger base, lift to the
    receptacle height, square up the yaw, push the prongs into the slots."""
    assert env.control_mode == "pd_ee_delta_pose"
    sv = _PoseServo(env, recorder)
    B = env.num_envs
    goal = np.asarray(env._goal_pose[:3])

    def chg():
        return _actor_pose(env, "charger")

    def yaw_err():
        out = np.zeros((B, 3), np.float32)
        out[:, 2] = -_yaw_of(chg()[1])
        return out

    def charger_x():
        return _quat_apply_np(chg()[1],
                              np.tile(np.array([1.0, 0, 0]), (B, 1)))

    tcp_yaw_to_charger = _tcp_x_across(env, charger_x)

    # grasp the base from above, fingers across the charger length
    sv.to(lambda: np.concatenate(
        [chg()[0][:, :2], np.full((B, 1), 0.08)], 1),
        steps=30, rot_fn=tcp_yaw_to_charger)
    sv.to(lambda: np.concatenate(
        [chg()[0][:, :2], np.full((B, 1), 0.013)], 1),
        steps=30, gain=2.5, clip=0.3, rot_fn=tcp_yaw_to_charger)
    sv.hold(8, grip=-1.0)
    # lift to wall height, square the charger (yaw -> 0), pre-position
    pre = goal + np.array([-0.03, 0.0, 0.0])
    for _ in range(45):
        err = pre - chg()[0]
        sv.act(np.clip(err * 2.5, -0.25, 0.25),
               np.clip(yaw_err() * 2.0, -0.3, 0.3), grip=-1.0)
    # slow insertion push
    for _ in range(50):
        err = goal - chg()[0]
        sv.act(np.clip(err * 2.0, -0.08, 0.08),
               np.clip(yaw_err() * 2.0, -0.2, 0.2), grip=-1.0)
    sv.hold(4, grip=-1.0)
    return sv.success()


def solve_pull_cube_tool(env, recorder=None):
    """PullCubeTool-v1 (reference solutions/pull_cube_tool.py): grasp the
    L-tool handle, hook behind the out-of-reach cube, drag it into the
    workspace."""
    assert env.control_mode == "pd_ee_delta_pos"
    sv = _PoseServo(env, recorder)
    B = env.num_envs
    hl, hk = env.handle_length, env.hook_length
    w = env.tool_width

    def tool():
        return _tcp_and_actor(env, "l_shape_tool")[1]

    def cube():
        return _tcp_and_actor(env, "cube")[1]

    # grasp the handle near the END CLOSEST to the robot: the cube spawns
    # at the reach boundary, so holding the far end wastes ~10 cm of the
    # tool's extension (reference pull_cube_tool.py grasps the handle end)
    grasp_off = np.array([-0.07, 0.0, 0.0])
    sv.to(lambda: tool() + grasp_off + np.array([0, 0, 0.07]), steps=32)
    sv.to(lambda: tool() + grasp_off + np.array([0, 0, 0.001]),
          steps=32, gain=2.5, clip=0.35)
    sv.hold(8, grip=-1.0)
    # carry the tool so the hook lands BEYOND the cube. Clearance matters:
    # carried at z=0.08 with 1.5 cm x-margin, the sagging hook end nudged
    # the cube and chased it off the table corner (debug trace: cube
    # 0.15 -> 0.21 m during the carry). Travel HIGH (z=0.14) with 4.5 cm
    # x-margin, then descend vertically before dragging.
    def tool_target(z, xoff=0.09):
        c = cube()
        tgt = np.empty((B, 3), np.float32)
        tgt[:, 0] = c[:, 0] + xoff - (hl / 2 - hk / 2)
        tgt[:, 1] = c[:, 1] - 2 * w
        tgt[:, 2] = z
        return tgt

    for _ in range(40):
        err = tool_target(0.14) - tool()
        sv.act(np.clip(err * 2.5, -0.35, 0.35), grip=-1.0)
    for _ in range(20):
        err = tool_target(0.012) - tool()
        sv.act(np.clip(err * 2.0, -0.2, 0.2), grip=-1.0)
    # drag back toward the robot base (hook engages after the 4.5 cm gap)
    for _ in range(60):
        d = np.tile(np.array([-0.30, 0.0, 0.0], np.float32), (B, 1))
        sv.act(d, grip=-1.0)
    sv.hold(4, grip=-1.0)
    return sv.success()


def solve_fold_suitcase(env, recorder=None):
    """FoldSuitcase-v1 (reference solutions/fold_suitcase.py: rim
    waypoints pulled along the closing arc, fold_suitcase.py:341-405):
    reach over the open lid, press the FAR face near the rim, and walk the
    contact point along the closing arc. Only the far face produces a
    closing torque — the near (robot-side) face's contact normal opens the
    hinge — so the press approaches from beyond the panel. Past vertical
    the lid's own weight closes it; the arm retreats up and away."""
    assert env.control_mode in ("pd_ee_delta_pos", "pd_ee_delta_pose")
    sv = _PoseServo(env, recorder)
    B = env.num_envs
    bh, lh = env.base_half, env.lid_half
    hinge = np.array([env.suitcase_x + bh[0], 0.0, 2 * bh[2]], np.float32)

    def lid_q():
        return _host(env)["qpos"][:, env._lid_body]

    def on_panel(q, s_from_tip, normal_off):
        """World point s_from_tip up the panel from the rim, offset along
        the far-face normal (panel local +z at q past vertical)."""
        c, s = np.cos(q), np.sin(q)
        vx = -(2 * lh[0] - s_from_tip)
        vz = lh[2]
        # R_y(q) @ (vx, 0, vz), then + normal_off * R_y(q) @ (0, 0, 1)
        x = vx * c + vz * s + normal_off * s
        z = -vx * s + vz * c + normal_off * c
        return hinge + np.stack(
            [x, np.zeros_like(x), z], 1).astype(np.float32)

    # 1) arc over the lid: hover high just beyond the rim (staying inside
    #    the reach envelope — large far-normal offsets at q~2.1 leave it)
    for _ in range(30):
        tcp, _ = _tcp_pose(env)
        tgt = on_panel(lid_q(), 0.0, 0.02) + np.array([0.0, 0, 0.12])
        sv.act(np.clip((tgt - tcp) * 3.0, -0.5, 0.5), grip=-1.0)
    # 2) descend onto the far face just below the rim
    for _ in range(25):
        tcp, _ = _tcp_pose(env)
        tgt = on_panel(lid_q(), 0.03, 0.035)
        sv.act(np.clip((tgt - tcp) * 2.5, -0.3, 0.3), grip=-1.0)
    # 3) press INTO the far face, tracking the panel ALL the way below the
    #    success angle: hinge dry friction (0.5 N m) exceeds the lid's
    #    gravity torque (<=0.13 N m), so the lid sticks wherever the press
    #    stops — gravity never finishes the close on its own
    q_stop = 0.85 * env.target_qpos
    for _ in range(170):
        q = lid_q()
        tcp, _ = _tcp_pose(env)
        tgt = on_panel(q, 0.04, -0.02)
        err = (tgt - tcp) * 3.0
        done = q < q_stop
        err = np.where(done[:, None], 0.0, err)
        sv.act(np.clip(err, -0.25, 0.25), grip=-1.0)
    # 4) retreat up/away so the falling lid doesn't land on the fingers
    for _ in range(18):
        sv.act(np.tile(np.array([0.25, 0, 0.4], np.float32), (B, 1)),
               grip=-1.0)
    sv.hold(22, grip=-1.0)  # lid settles closed on the base
    return sv.success()


SOLUTIONS = {
    "PickCube-v1": solve_pick_cube,
    "PushCube-v1": solve_push_cube,
    "PullCube-v1": solve_pull_cube,
    "StackCube-v1": solve_stack_cube,
    "RollBall-v1": solve_roll_ball,
    "PickSingleHull-v1": solve_pick_object,
    "LiftPegUpright-v1": solve_lift_peg_upright,
    "PegInsertionSide-v1": solve_peg_insertion_side,
    "PlugCharger-v1": solve_plug_charger,
    "PullCubeTool-v1": solve_pull_cube_tool,
    "FoldSuitcase-v1": solve_fold_suitcase,
}

# control mode each solution drives (default pd_ee_delta_pos)
CONTROL_MODES = {
    "LiftPegUpright-v1": "pd_ee_delta_pose",
    "PegInsertionSide-v1": "pd_ee_delta_pose",
    "PlugCharger-v1": "pd_ee_delta_pose",
}
