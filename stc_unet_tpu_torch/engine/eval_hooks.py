"""EvalHook (≙ ``stc_unet_tpu/engine/eval_hooks.py``): ``single_gpu_test(
pre_eval=True)`` over the val loader every ``interval`` epochs (or
iterations), ``dataset.evaluate``, the metrics into the log buffer, and
with ``save_best`` the best checkpoint kept as
``best_{key}_{epoch|iter}_{n}.pth`` (written by rank 0 alone).
``DistEvalHook`` evaluates the ranks' shards of the val split through
``multi_gpu_test``, whose merged results every rank evaluates.
"""
from __future__ import annotations

import os
import os.path as osp
from math import inf
from typing import Optional

from .checkpoint import save_checkpoint
from .hooks import HOOKS, Hook


@HOOKS.register_module()
class EvalHook(Hook):

    rule_map = {'greater': lambda x, y: x > y, 'less': lambda x, y: x < y}
    init_value_map = {'greater': -inf, 'less': inf}
    greater_keys = ['acc', 'top', 'AR@', 'auc', 'precision', 'mAP', 'mDice',
                    'mIoU', 'mAcc', 'aAcc', 'mFscore']
    less_keys = ['loss']

    def __init__(self, dataloader, start=None, interval=1, by_epoch=True,
                 save_best: Optional[str] = None, rule: Optional[str] = None,
                 test_fn=None, greater_keys=None, less_keys=None,
                 out_dir=None, pre_eval=True,
                 **eval_kwargs):
        if not (hasattr(dataloader, '__iter__')
                and hasattr(dataloader, '__len__')
                and hasattr(dataloader, 'dataset')):
            raise TypeError('dataloader must be a DataLoader (built by '
                            'build_dataloader), got '
                            f'{type(dataloader).__name__}')
        self.dataloader = dataloader
        self.interval = interval
        self.start = start
        self.by_epoch = by_epoch
        self.save_best = save_best
        self.eval_kwargs = eval_kwargs
        self.pre_eval = pre_eval
        self.out_dir = out_dir
        if test_fn is None:
            from stc_unet_tpu_torch.apis.test import single_gpu_test
            test_fn = single_gpu_test
        self.test_fn = test_fn
        if greater_keys is not None:
            self.greater_keys = greater_keys
        if less_keys is not None:
            self.less_keys = less_keys
        self.best_ckpt_path = None
        self.rule = rule
        if self.save_best is not None:
            self._init_rule(rule, self.save_best)

    def _init_rule(self, rule, key_indicator):
        if rule not in self.rule_map and rule is not None:
            raise KeyError(f'rule must be greater, less or None, got {rule}')
        if rule is None and key_indicator != 'auto':
            kl = key_indicator.lower()
            if any(k.lower() in kl for k in self.greater_keys):
                rule = 'greater'
            elif any(k.lower() in kl for k in self.less_keys):
                rule = 'less'
            else:
                raise ValueError(
                    f'Cannot infer the rule for key {key_indicator}')
        self.rule = rule
        self.key_indicator = key_indicator
        if self.rule is not None:
            self.compare_func = self.rule_map[self.rule]

    def _should_evaluate(self, runner):
        if self.by_epoch:
            current, check_time = runner.epoch, self.every_n_epochs
        else:
            current, check_time = runner.iter, self.every_n_iters
        if self.start is None:
            return check_time(runner, self.interval)
        if current + 1 < self.start:
            return False
        return (current + 1 - self.start) % self.interval == 0

    def after_train_iter(self, runner):
        if not self.by_epoch and self._should_evaluate(runner):
            self._do_evaluate(runner)

    def after_train_epoch(self, runner):
        if self.by_epoch and self._should_evaluate(runner):
            self._do_evaluate(runner)

    def _do_evaluate(self, runner):
        results = self.test_fn(runner.model, self.dataloader,
                               pre_eval=self.pre_eval)
        runner.log_buffer.clear()
        runner.log_buffer.output['eval_iter_num'] = len(self.dataloader)
        key_score = self.evaluate(runner, results)
        if self.save_best and key_score is not None:
            self._save_ckpt(runner, key_score)

    def evaluate(self, runner, results):
        eval_res = self.dataloader.dataset.evaluate(
            results, logger=runner.logger, **self.eval_kwargs)
        for name, val in eval_res.items():
            runner.log_buffer.output[name] = val
        runner.log_buffer.ready = True
        if self.save_best is not None:
            if self.key_indicator == 'auto':
                self._init_rule(self.rule, list(eval_res.keys())[0])
            return eval_res[self.key_indicator]
        return None

    def _save_ckpt(self, runner, key_score):
        hook_msgs = runner.meta.setdefault('hook_msgs', {})
        best_score = hook_msgs.get('best_score',
                                   self.init_value_map[self.rule])
        if not self.compare_func(key_score, best_score):
            return
        out_dir = self.out_dir or runner.work_dir
        cur = f'epoch_{runner.epoch + 1}' if self.by_epoch else \
            f'iter_{runner.iter + 1}'
        name = f'best_{self.key_indicator}_{cur}.pth'
        last, self.best_ckpt_path = self.best_ckpt_path, \
            osp.join(out_dir, name)
        if runner.rank == 0:
            if last and osp.isfile(last):
                os.remove(last)
            save_checkpoint(runner.model, self.best_ckpt_path,
                            meta=dict(epoch=runner.epoch + 1,
                                      iter=runner.iter + 1,
                                      best_score=float(key_score)))
        hook_msgs['best_score'] = float(key_score)
        hook_msgs['best_ckpt'] = self.best_ckpt_path
        runner.logger.info(
            f'Now best checkpoint is saved as {name} '
            f'(best {self.key_indicator}={key_score:.4f}).')


@HOOKS.register_module()
class DistEvalHook(EvalHook):
    """Evaluation over the ranks of a data-parallel run (≙ the JAX
    ``DistEvalHook``): each rank runs its shard of the val loader through
    ``test_fn`` (default ``multi_gpu_test``), which gives every rank the
    merged result list, so every rank takes the same metrics and the
    same ``save_best`` decision. Every rank must evaluate.

    ``broadcast_bn_buffer``, ``tmpdir`` and ``gpu_collect`` are accepted
    for the reference's configs and change nothing: the global-batch
    ``BatchNorm`` of the data-parallel train step leaves the ranks'
    running stats equal, so there is nothing to broadcast."""

    def __init__(self, *args, broadcast_bn_buffer=True, tmpdir=None,
                 gpu_collect=False, **kwargs):
        if kwargs.get('test_fn') is None:
            from stc_unet_tpu_torch.apis.test import multi_gpu_test
            kwargs['test_fn'] = multi_gpu_test
        super().__init__(*args, **kwargs)
        self.broadcast_bn_buffer = broadcast_bn_buffer
        self.tmpdir = tmpdir
        self.gpu_collect = gpu_collect

    def _do_evaluate(self, runner):
        tmpdir = self.tmpdir or osp.join(runner.work_dir, '.eval_hook')
        results = self.test_fn(runner.model, self.dataloader, tmpdir=tmpdir,
                               gpu_collect=self.gpu_collect,
                               pre_eval=self.pre_eval)
        runner.log_buffer.clear()
        runner.log_buffer.output['eval_iter_num'] = len(self.dataloader)
        key_score = self.evaluate(runner, results)
        if self.save_best and key_score is not None:
            self._save_ckpt(runner, key_score)
